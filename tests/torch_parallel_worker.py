"""One rank of ``tests/test_torch_parallel.py``: joins a gloo process group
of WORLD ranks on the CPU, runs the named tasks on the inputs the test wrote
into DIR, and saves each task's results as ``DIR/<task>_rank<RANK>.pt``.

    python torch_parallel_worker.py RANK WORLD DIR TASK[,TASK...]

Imports torch and the port only.
"""

import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from confild_tpu_torch import config as cfgmod
from confild_tpu_torch.cli import sample_conditional
from confild_tpu_torch.diffusion import create_gaussian_diffusion
from confild_tpu_torch.diffusion.resample import LossSecondMomentResampler
from confild_tpu_torch.io import checkpoint as ckpt_io
from confild_tpu_torch.models import unet as tunet
from confild_tpu_torch.models.unet_extras import create_classifier
from confild_tpu_torch.ops.ring_attention import ring_attention
from confild_tpu_torch.parallel import mesh as pmesh
from confild_tpu_torch.train.classifier_trainer import ClassifierTrainLoop
from confild_tpu_torch.train.cnf_trainer import CNFTrainer
from confild_tpu_torch.train.diffusion_trainer import TrainLoop
from confild_tpu_torch.utils import logger as tlog


def task_mesh(d):
    mesh = pmesh.get_mesh()
    x = torch.arange(16 * 3, dtype=torch.float32).reshape(16, 3)
    out = {"shard": pmesh.shard_batch(x, mesh).clone(),
           "shard_axis1": pmesh.shard_batch({"a": x.numpy().T}, mesh, axis=1)["a"].copy(),
           "gathered": pmesh.all_gather_cat(torch.tensor([float(dist.get_rank())]), mesh),
           "shape": mesh.shape, "spec": pmesh.batch_spec(mesh)}
    rep = {"a": torch.full((3,), float(dist.get_rank()) + 1.0)}
    out["replicated"] = pmesh.replicate(rep, mesh)["a"]
    try:
        pmesh.get_mesh(dist.get_world_size() + 1)
    except ValueError as e:
        out["too_many"] = str(e)
    if dist.get_world_size() == 4:
        hybrid = pmesh.get_hybrid_mesh(2)
        out.update(hybrid_names=hybrid.axis_names, hybrid_shape=tuple(hybrid.ranks.shape),
                   hybrid_axes=pmesh.batch_axes(hybrid), hybrid_spec=pmesh.batch_spec(hybrid),
                   hybrid_shard=pmesh.shard_batch(x, hybrid).clone())
        try:
            pmesh.get_hybrid_mesh(3)
        except ValueError as e:
            out["uneven"] = str(e)
    return out


def task_ring(d):
    """Forward and gradients of ``sum(ring_attention(q, k, v) * g)``."""
    q, k, v, g = (torch.from_numpy(a) for a in np.load(os.path.join(d, "ring.npy")))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ring_attention(*leaves, pmesh.get_mesh())
    (out * g).sum().backward()
    return {"out": out.detach(), "dq": leaves[0].grad, "dk": leaves[1].grad,
            "dv": leaves[2].grad}


def task_unet_ring(d):
    """The U-Net with a 2-rank seq_mesh and ring_min_tokens below its
    attention blocks' tokens: output and gradients of ``sum(out * g)``."""
    inp = torch.load(os.path.join(d, "unet_ring.pt"), weights_only=False)
    base = tunet.create_model(**inp["config"])
    model = tunet.UNetModel(base.cfg, seq_mesh=pmesh.get_mesh(),
                            ring_min_tokens=inp["ring_min_tokens"])
    model.load_state_dict(inp["state_dict"])
    out = model(inp["x"], inp["t"])
    (out * inp["g"]).sum().backward()
    return {"out": out.detach(), "grads": {n: p.grad for n, p in model.named_parameters()}}


def _loop(d, inp, sub, **kw):
    model = tunet.create_model(**inp["config"])
    model.load_state_dict(inp["state_dict"])
    return TrainLoop(model=model, diffusion=create_gaussian_diffusion(
        steps=20, noise_schedule="cosine"), data=None, batch_size=8,
        save_dir=os.path.join(d, sub), mesh=pmesh.get_mesh(), device="cpu", **kw)


def task_train(d):
    """One step on the global batch with the given draws (and the same
    with microbatches), then two rank-0 saves with rotation to one
    generation, read back on every rank."""
    inp = torch.load(os.path.join(d, "train.pt"), weights_only=False)
    tlog.configure(os.path.join(d, "logs"), [])
    res = {}
    for name, micro in (("full", -1), ("micro", 4)):
        loop = _loop(d, inp, f"ckpt_{name}", microbatch=micro, keep_checkpoints=1,
                     **inp["loop"])
        metrics = loop.train_step(inp["batch"], *inp["draws"])
        res[name] = {"metrics": metrics,
                     "grads": {n: p.grad.clone() for n, p in loop.model.named_parameters()},
                     "params": {k: v.clone() for k, v in loop.model.state_dict().items()},
                     "ema": {k: v.clone() for k, v in loop.ema_state_dict(0).items()},
                     "valid_mse": loop.valid_step(inp["batch"], *inp["draws"])}
    loop.save()
    loop.train_step(inp["batch"], *inp["draws"])
    paths = loop.save()
    saved = torch.load(paths["model"], weights_only=True)
    res["files"] = sorted(os.listdir(loop.save_dir))
    res["read_back"] = all(torch.equal(saved[k], v) for k, v in loop.model.state_dict().items())
    # rotation is rank 0's: another rank deletes nothing
    rot = os.path.join(d, "rotate")
    if dist.get_rank() == 0:
        os.makedirs(rot)
        for step in (1, 2):
            open(os.path.join(rot, f"model{step:06d}.pt"), "w").close()
    dist.barrier()
    if dist.get_rank() > 0:
        res["rotated"] = ckpt_io.rotate_checkpoints(rot, 1, kind="diffusion")
    dist.barrier()
    if dist.get_rank() == 0:
        res["rotated"] = ckpt_io.rotate_checkpoints(rot, 1, kind="diffusion")
    dist.barrier()
    res["rotate_left"] = sorted(os.listdir(rot))
    return res


def task_sampler(d):
    """The loss-aware sampler's state after three steps."""
    inp = torch.load(os.path.join(d, "train.pt"), weights_only=False)
    tlog.configure(os.path.join(d, "logs"), [])
    loop = _loop(d, inp, "sampler", schedule_sampler=LossSecondMomentResampler(20, 2),
                 **inp["loop"])
    for t in inp["sampler_t"]:
        loop.train_step(inp["batch"], t, torch.ones(8), inp["draws"][2])
    return loop.sampler_state


def _cnf(d, mesh):
    hp = cfgmod.basic_input(os.path.join(d, "cnf", "case.yml"),
                            save_path=os.path.join(d, "cnf", f"run_{mesh.size}"))
    tr = CNFTrainer(hp, device="cpu", mesh=mesh)
    tr.init_state(seed=0)
    tr.train(log_formats=())
    return {"latents": tr.state.latents.detach().clone(),
            "params": {k: v.clone() for k, v in tr.model.state_dict().items()},
            "accum": {n: p.grad.clone() for n, p in tr.model.named_parameters()},
            "rmae": tr.eval_rmae(), "files": sorted(os.listdir(hp.save_path))}


def task_cnf(d):
    return _cnf(d, pmesh.get_mesh())


def task_cnf_hybrid(d):
    return _cnf(d, pmesh.get_hybrid_mesh(2))


def task_dps(d):
    return sample_conditional.main([os.path.join(d, "dps.yml")])


def task_classifier(d):
    """Two ``ClassifierTrainLoop`` steps on the global batch with the given
    draws (DDP over the mesh), then a rank-0 save read back on every rank."""
    inp = torch.load(os.path.join(d, "classifier.pt"), weights_only=False)
    tlog.configure(os.path.join(d, "logs"), [])
    model = create_classifier(**inp["config"])
    model.load_state_dict(inp["state_dict"])
    loop = ClassifierTrainLoop(model=model, diffusion=create_gaussian_diffusion(
        steps=20, noise_schedule="cosine"), data=None, batch_size=4, lr=3e-3,
        lr_anneal_steps=4, save_dir=os.path.join(d, "clf"), mesh=pmesh.get_mesh(),
        device="cpu")
    res = {"metrics": [loop.train_step(*step) for step in inp["steps"]],
           "grads": {n: p.grad.clone() for n, p in loop.model.named_parameters()},
           "params": {k: v.clone() for k, v in loop.model.state_dict().items()}}
    saved = torch.load(loop.save()["model"], weights_only=True)
    res["read_back"] = all(torch.equal(saved[k], v) for k, v in loop.model.state_dict().items())
    return res


def main():
    rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    pmesh.initialize_distributed("cpu", init_method="file://" + os.path.join(d, "store"),
                                 world_size=world, rank=rank,
                                 timeout=datetime.timedelta(seconds=120))
    try:
        for task in sys.argv[4].split(","):
            torch.save(globals()[f"task_{task}"](d), os.path.join(d, f"{task}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    print(f"rank {rank} OK")


if __name__ == "__main__":
    main()
