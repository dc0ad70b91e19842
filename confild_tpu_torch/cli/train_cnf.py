"""CNF training CLI (reference ``ConditionalNeuralField/scripts/train.py``
``__main__``; ``confild_tpu/cli/train_cnf.py``):

    python -m confild_tpu_torch.cli.train_cnf recipe.yml
    torchrun --nproc-per-node N -m confild_tpu_torch.cli.train_cnf recipe.yml

Keys follow the JAX package's CNF recipes (``recipes/cnf/*.yml``), plus
``device`` (optional; the default is the CUDA card, ``cuda:LOCAL_RANK``
under torchrun).  ``multiGPU`` maps onto a data mesh of ``min(multiGPU,
ranks)`` ranks, as the JAX CLI maps it onto devices: with one process a
``multiGPU: 2`` recipe trains on one device; ranks beyond the mesh take no
part.
"""

from __future__ import annotations

import sys

from confild_tpu_torch import config as cfgmod
from confild_tpu_torch.parallel import mesh as pmesh
from confild_tpu_torch.train.cnf_trainer import CNFTrainer


def main(argv=None) -> CNFTrainer | None:
    """Resume from the newest checkpoint (or start from scratch), train
    ``epochs`` epochs; returns the trainer (None on a rank outside the
    mesh)."""
    argv = argv if argv is not None else sys.argv[1:]
    hp = cfgmod.basic_input(argv[0])
    device = pmesh.initialize_distributed(hp.get("device"))
    n = min(int(hp.get("multiGPU", 1) or 1), pmesh.process_count())
    mesh = pmesh.get_mesh(n) if n > 1 else None
    if mesh is None and pmesh.process_index() > 0 or mesh is not None and not mesh.member:
        print(f"rank {pmesh.process_index()}: outside the {n}-rank mesh, not training")
        return None
    trainer = CNFTrainer(hp, device=device, mesh=mesh)
    trainer.load(-1)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
