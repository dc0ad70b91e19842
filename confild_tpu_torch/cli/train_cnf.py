"""CNF training CLI (reference ``ConditionalNeuralField/scripts/train.py``
``__main__``; ``confild_tpu/cli/train_cnf.py``):

    python -m confild_tpu_torch.cli.train_cnf recipe.yml

Keys follow the JAX package's CNF recipes (``recipes/cnf/*.yml``), plus
``device`` (optional; the default is the CUDA card).  ``multiGPU`` above 1
still trains on one card.
"""

from __future__ import annotations

import sys

from confild_tpu_torch import config as cfgmod
from confild_tpu_torch.train.cnf_trainer import CNFTrainer


def main(argv=None) -> CNFTrainer:
    """Resume from the newest checkpoint (or start from scratch), train
    ``epochs`` epochs; returns the trainer."""
    argv = argv if argv is not None else sys.argv[1:]
    hp = cfgmod.basic_input(argv[0])
    trainer = CNFTrainer(hp)
    trainer.load(-1)
    trainer.train()
    return trainer


if __name__ == "__main__":
    main()
