"""Entry ``image_train``: the port's image-model training step,
``parallel.dp.make_bn_train_step`` on ``models.resnet.make_loss_fn``, with
SGD and Nesterov momentum, fed a pool of batches that lives on the card.

The weights and the batch-norm buffers are the benchmark's
(``weights.make`` over ``reference.resnet50.param_spec`` and
``buffer_spec``), copied into the port's model; the port's own initialiser
is not run.
"""

from __future__ import annotations

import itertools

import torch

from portbench import roofline, traffic, weights
from portbench.reference import resnet50 as reference_resnet

# the leaves of the buffer spec come from another stream than the parameters
BUFFER_SEED_OFFSET = 1


def model_config(cfg: dict) -> dict:
    if tuple(cfg["stage_sizes"]) != (3, 4, 6, 3):
        raise ValueError("the port's resnet50 has stages (3, 4, 6, 3)")
    return {"num_classes": cfg["num_classes"], "width": cfg["width"], "stem": "imagenet",
            "bf16": cfg["compute_dtype"] == "bfloat16",
            "bf16_norm": cfg["norm_dtype"] == "bfloat16"}


def _weights(cfg, seed, device):
    return (weights.make(reference_resnet.param_spec(cfg), seed, device),
            weights.make(reference_resnet.buffer_spec(cfg), seed + BUFFER_SEED_OFFSET, device))


def reference(cfg: dict, mix: dict, seed: int, device, n_steps: int,
              precision: str = "float32") -> dict:
    w, buf = _weights(cfg, seed, device)
    pool = traffic.generate(mix, cfg, seed, device)
    return reference_resnet.readings(cfg, w, buf, pool[:n_steps], cfg["optimizer"], precision)


class Session:
    def __init__(self, cfg: dict, mix: dict, seed: int, device, log):
        from tensorflowonspark_torch.models import layers
        from tensorflowonspark_torch.models import resnet
        from tensorflowonspark_torch.parallel import dp

        self.cfg, self.seed, self.device = cfg, seed, device
        self.batch = mix["batch"]
        self.units_per_step, self.unit = self.batch, "images"
        with torch.device("meta"):
            model = resnet.build_resnet50(model_config(cfg))
        model = model.to_empty(device=device)
        for m in model.modules():
            if isinstance(m, layers.BatchNorm) and (m.momentum, m.epsilon) != (
                    cfg["bn_momentum"], cfg["bn_epsilon"]):
                raise ValueError(f"the port's BatchNorm has momentum {m.momentum}, eps "
                                 f"{m.epsilon}; the configuration states "
                                 f"{cfg['bn_momentum']}, {cfg['bn_epsilon']}")
        self._load(model)
        opt = cfg["optimizer"]
        optimizer = torch.optim.SGD(model.parameters(), lr=opt["lr"], momentum=opt["momentum"],
                                    nesterov=opt["nesterov"])
        self.state = dp.BNTrainState.create(model, optimizer)
        self.step_fn = dp.make_bn_train_step(
            resnet.make_loss_fn(model, weight_decay=cfg["weight_decay"]), optimizer)
        fwd, _ = roofline.resnet_forward_flops(mix["image_size"], cfg["num_classes"],
                                               cfg["width"], tuple(cfg["stage_sizes"]))
        self.shapes = {"step_flops": 3 * fwd * self.batch}
        self.pool = traffic.generate(mix, cfg, seed, device)
        self.order = itertools.cycle(self.pool)
        log(f"[image_train] {sum(p.numel() for p in model.parameters()) / 1e6:.2f} M f32 "
            f"master parameters, {cfg['compute_dtype']} compute, B={self.batch} at "
            f"{mix['image_size']} px, SGD lr {opt['lr']} momentum {opt['momentum']} "
            f"nesterov {opt['nesterov']}, L2 {cfg['weight_decay']}; a pool of "
            f"{len(self.pool)} distinct batches on the card; forward {fwd / 1e9:.4f} GFLOP "
            f"an image")

    def _load(self, model):
        params, buffers = _weights(self.cfg, self.seed, self.device)
        named = {**dict(model.named_parameters()), **dict(model.named_buffers())}
        want = {n: tuple(t.shape) for n, t in {**params, **buffers}.items()}
        have = {n: tuple(t.shape) for n, t in named.items()}
        if have != want:
            raise ValueError(f"the port's leaves {have} differ from the spec {want}")
        with torch.no_grad():
            for name, w in {**params, **buffers}.items():
                named[name].copy_(w)

    def next_batch(self):
        return next(self.order)

    def train_step(self, batch):
        self.state, metrics = self.step_fn(self.state, batch)
        return metrics["loss"]

    def first_steps(self, n: int, log) -> dict:
        optimizer, model = self.state.optimizer, self.state.model
        out = {"loss": [], "grad_norm": {}, "change_norm": {}}
        losses = []
        for t in range(1, n + 1):
            losses.append(self.train_step(self.next_batch()))
            if t == 1:  # SGD's momentum buffer after one step is the gradient
                with torch.no_grad():
                    for name, p in model.named_parameters():
                        g = optimizer.state.get(p, {}).get("momentum_buffer", torch.zeros(()))
                        out["grad_norm"][name] = torch.linalg.vector_norm(g).item()
        out["loss"] = [x.item() for x in losses]
        params, buffers = _weights(self.cfg, self.seed, self.device)
        start = {**params, **buffers}
        with torch.no_grad():
            for name, t in [*model.named_parameters(), *model.named_buffers()]:
                out["change_norm"][name] = torch.linalg.vector_norm(t - start[name]).item()
        return out

    def close(self):
        self.state = self.step_fn = self.pool = self.order = None


def build(cfg: dict, mix: dict, seed: int, device, log) -> Session:
    return Session(cfg, mix, seed, device, log)
