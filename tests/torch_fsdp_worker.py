"""One rank of the gloo world that ``tests/test_torch_fsdp.py`` spawns (4 CPU
processes, one ``dp=2 × fsdp=2`` mesh): the small ResNet's BN train step
over the mesh, then a collective save of its fsdp state and a restore onto
a fresh state of the same mesh, and a collective ``export_bundle`` of the
model's ``Shard``s into ``<dir>/bundle``.  The weights and the global batch come from
``<dir>/bn.pt`` (converted by the test from the JAX package's variables);
results go to ``<dir>/rank<r>.npz`` (errors to ``<dir>/errors<r>.json``).
Imports only the port.

    python tests/torch_fsdp_worker.py --rank R --world 4 --port P --dir D
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tensorflowonspark_torch import checkpoint as ckptlib  # noqa: E402
from tensorflowonspark_torch.models import resnet as tres  # noqa: E402
from tensorflowonspark_torch.parallel import dp as dplib  # noqa: E402
from tensorflowonspark_torch.parallel import mesh as meshlib  # noqa: E402
from tensorflowonspark_torch.parallel import tp as tplib  # noqa: E402

STEPS = 3
# the BN trajectory test's model (tests/test_torch_resnet.py), float64
STAGES = dict(stage_sizes=(1, 1, 1), num_classes=10, width=8, stem="cifar")


def build(mesh, weights: dict):
    """The model on the mesh: rank 0's weights everywhere (``replicate``,
    which also gives its BatchNorms the batch group), every parameter cut
    over ``fsdp`` (``shard_model(rules=())``), SGD with Nesterov momentum
    over the blocks, the BN step over the mesh."""
    model = tres.ResNet(**STAGES, compute_dtype=torch.float64,
                        norm_dtype=torch.float64).double()
    model.load_state_dict(weights, strict=True)
    dplib.replicate(model, mesh)
    tplib.shard_model(model, mesh, rules=())
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9, nesterov=True)
    step = dplib.make_bn_train_step(tres.make_loss_fn(model, weight_decay=1e-4), opt,
                                    mesh=mesh)
    return dplib.BNTrainState.create(model, opt), step


def numpy_tree(tree: dict) -> dict:
    """Copies: a state dict's tensors are the live buffers."""
    return {k: v.detach().cpu().numpy().copy() for k, v in tree.items()}


def run(env_dir: str, out: dict) -> None:
    mesh = meshlib.make_mesh("cpu", dp=2, fsdp=2)
    data = torch.load(os.path.join(env_dir, "bn.pt"))
    rows = data["image"].shape[0] // 4
    first = meshlib.axis_index(mesh, "dp", "fsdp") * rows
    batch = {"image": data["image"][first:first + rows], "label": data["label"][first:first + rows]}
    state, step = build(mesh, data["weights"])
    model = state.model
    out["sharded_dims"] = np.asarray(sum(
        1 for s in model.tos_shardings.values() if "fsdp" in sum(
            (s.axes_of(d) for d in range(len(s.spec))), ())))
    for i in range(STEPS):
        state, metrics = step(state, batch)
        out[f"step{i}/loss"] = np.asarray(metrics["loss"].item())
        for k, v in numpy_tree(tplib.full_parameters(model, mesh)).items():
            out[f"step{i}/param/{k}"] = v
        for k, v in numpy_tree(tplib.full_parameters(model, mesh, grads=True)).items():
            out[f"step{i}/grad/{k}"] = v
        for k, v in numpy_tree(model.state_dict()).items():
            if k.endswith(("running_mean", "running_var")):
                out[f"step{i}/stats/{k}"] = v

    # the collective save of the fsdp state, and a restore onto the same mesh
    manager = ckptlib.CheckpointManager(os.path.join(env_dir, "ckpt"))
    tree = state.tree()
    out["shard_leaves"] = np.asarray(sum(
        1 for _, leaf in ckptlib._leaves(tree) if isinstance(leaf, ckptlib.Shard)))
    manager.save(state.step, tree)
    manager.wait()
    for k, v in numpy_tree(tplib.full_parameters(model, mesh)).items():
        out[f"full/{k}"] = v
    # the same state's model as an inference bundle: a collective of every rank
    ckptlib.export_bundle(os.path.join(env_dir, "bundle"), tree["model"],
                          {"model": "resnet_cifar", "depth_blocks": 1, "width": 8})
    fresh, fresh_step = build(mesh, data["weights"])
    restored, at = manager.restore_latest(fresh.tree())
    fresh = fresh.restore(restored)
    want, got = state.tree(), fresh.tree()
    same = all(torch.equal(dplib._blocks(a), dplib._blocks(b))
               for (_, a), (_, b) in zip(ckptlib._leaves(want), ckptlib._leaves(got))
               if isinstance(dplib._blocks(a), torch.Tensor))
    out["restored_step"] = np.asarray([at, fresh.step])
    out["restored_equal"] = np.asarray(same)
    out["restored_leaves"] = np.asarray([len(ckptlib._leaves(want)), len(ckptlib._leaves(got))])
    # one more step from each: the same loss to the bit
    _, m_live = step(state, batch)
    _, m_restored = fresh_step(fresh, batch)
    out["next_loss"] = np.asarray([m_live["loss"].item(), m_restored["loss"].item()])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--dir", required=True)
    args = ap.parse_args(argv)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.port}",
                            rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=90))
    out: dict = {}
    errors = {}
    try:
        run(args.dir, out)
    except Exception:  # noqa: BLE001 - reported to the test
        errors["run"] = traceback.format_exc()
    finally:
        np.savez(os.path.join(args.dir, f"rank{args.rank}.npz"), **out)
        with open(os.path.join(args.dir, f"errors{args.rank}.json"), "w") as f:
            json.dump(errors, f)
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
