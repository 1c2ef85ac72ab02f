"""Entry ``lm_train``: the port's LM training path as a TensorFlowOnSpark
node runs it.  A producer thread pushes the mix's rows into the node's
``feeding.FeedQueues``, one partition a step, as the data server would;
``feeding.DataFeed`` → ``parallel.dp.make_batch_iterator`` (its prefetch
thread puts each batch on the card) → ``parallel.dp.make_train_step`` on
``models.transformer.make_loss_fn`` with ``parallel.dp.adamw``.

The weights are the benchmark's (``weights.make`` over
``reference.lm.param_spec``), copied into the port's model; the port's own
initialiser is not run.
"""

from __future__ import annotations

import itertools
import queue
import threading

import numpy as np
import torch

from portbench import roofline, traffic, weights
from portbench.reference import lm as reference_lm

PUT_TIMEOUT_S = 0.1


def model_config(cfg: dict) -> dict:
    """The port's ``build_transformer`` config for ``cfg``, after checking
    that the port's model can state it: as many KV heads as heads, RMSNorm
    eps 1e-6 (the port's ``RMSNorm`` default), an untied head."""
    if cfg["num_key_value_heads"] != cfg["num_attention_heads"]:
        raise ValueError("the port's transformer has as many KV heads as heads")
    if cfg["rms_norm_eps"] != 1e-6 or cfg["tie_word_embeddings"]:
        raise ValueError("the port's transformer takes RMSNorm eps 1e-6 and an untied head")
    if cfg["hidden_act"] != "silu":
        raise ValueError("the port's transformer's MLP is SwiGLU")
    return {"vocab_size": cfg["vocab_size"], "d_model": cfg["hidden_size"],
            "n_layers": cfg["num_hidden_layers"], "n_heads": cfg["num_attention_heads"],
            "d_head": cfg["head_dim"], "d_ff": cfg["intermediate_size"],
            "rope_theta": cfg["rope_theta"], "bf16": cfg["compute_dtype"] == "bfloat16",
            "attn_impl": "auto"}


def batches_for_reference(cfg: dict, mix: dict, seed: int, n: int, device) -> list:
    """The first ``n`` batches the program trains on, made again."""
    pool = traffic.generate(mix, cfg, seed, device)
    return [torch.from_numpy(pool[i]).to(device) for i in range(n)]


def reference(cfg: dict, mix: dict, seed: int, device, n_steps: int,
              precision: str = "float32") -> dict:
    w = weights.make(reference_lm.param_spec(cfg), seed, device)
    return reference_lm.readings(cfg, w, batches_for_reference(cfg, mix, seed, n_steps, device),
                                 cfg["optimizer"], precision)


class Session:
    """The program, built and fed; ``next_batch`` and ``train_step`` are
    the window's two calls."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device, log):
        from tensorflowonspark_torch.feeding import DataFeed, FeedQueues
        from tensorflowonspark_torch.models import transformer as tfm
        from tensorflowonspark_torch.ops import attention as att
        from tensorflowonspark_torch.parallel import dp

        self.cfg, self.seed, self.device = cfg, seed, device
        self.att = att
        self.batch, self.seq = mix["batch"], mix["seq_len"]
        self.units_per_step = self.batch * self.seq
        self.unit = "tokens"
        spec = reference_lm.param_spec(cfg)
        with torch.device("meta"):
            model = tfm.build_transformer(model_config(cfg))
        model = model.to_empty(device=device)
        self._load(model, spec)
        opt = cfg["optimizer"]
        optimizer = dp.adamw(model.parameters(), opt["lr"])
        group = optimizer.param_groups[0]
        if (tuple(group["betas"]), group["eps"], group["weight_decay"]) != (
                tuple(opt["betas"]), opt["eps"], opt["weight_decay"]):
            raise ValueError(f"the port's AdamW is {group}, the configuration states {opt}")
        self.state = dp.TrainState.create(model, optimizer)
        self.step_fn = dp.make_train_step(tfm.make_loss_fn(model), optimizer)
        d = cfg["head_dim"]
        self.shapes = {
            "attention": {"batch": self.batch, "seq": self.seq,
                          "heads": cfg["num_attention_heads"], "head_dim": d,
                          "layers": cfg["num_hidden_layers"], "itemsize": 2},
            "step_flops": roofline.lm_step_flops(
                cfg["vocab_size"], cfg["hidden_size"], cfg["num_hidden_layers"],
                cfg["num_attention_heads"], d, cfg["intermediate_size"],
                self.batch, self.seq)[0]}
        pool = traffic.generate(mix, cfg, seed, device)
        self.queues = FeedQueues(capacity=(self.batch + 1) * mix["queued_steps"])
        self.stop = threading.Event()
        self.producer = threading.Thread(target=self._produce, args=(pool,),
                                         name="portbench-producer", daemon=True)
        self.producer.start()
        self.feed = DataFeed(self.queues, train_mode=True, stop_event=self.stop,
                             poll_interval=0.05)
        self.batches = dp.make_batch_iterator(self.feed, self.batch, self._to_arrays,
                                              prefetch=mix["prefetch"])
        log(f"[lm_train] {sum(p.numel() for p in model.parameters()) / 1e9:.4f} B f32 "
            f"master parameters, {cfg['compute_dtype']} compute, B={self.batch} "
            f"S={self.seq}, AdamW lr {opt['lr']} (fused={group.get('fused')}), a pool of "
            f"{len(pool)} distinct batches through FeedQueues -> DataFeed -> "
            f"make_batch_iterator(prefetch={mix['prefetch']})")

    def _load(self, model, spec):
        named = dict(model.named_parameters())
        want = {n: tuple(s) for n, s, _ in spec}
        have = {n: tuple(p.shape) for n, p in named.items()}
        if have != want:
            raise ValueError(f"the port's parameters {have} differ from the spec {want}")
        with torch.no_grad():
            for name, w in weights.make(spec, self.seed, self.device).items():
                named[name].copy_(w)

    def _to_arrays(self, rows):
        return {"input_ids": torch.from_numpy(np.stack(rows)).to(self.device)}

    def _put(self, q, item) -> bool:
        while not self.stop.is_set():
            try:
                q.put(item, timeout=PUT_TIMEOUT_S)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, pool):
        from tensorflowonspark_torch.marker import EndPartition

        q = self.queues.get_queue("input")
        for batch in itertools.cycle(pool):
            for row in batch:
                if not self._put(q, row):
                    return
            if not self._put(q, EndPartition()):
                return

    def next_batch(self):
        batch, n = next(self.batches)
        if n != self.batch:
            raise RuntimeError(f"the feed gave {n} real rows, expected {self.batch}")
        return batch

    def train_step(self, batch):
        self.state, metrics = self.step_fn(self.state, batch)
        return metrics["loss"]

    def first_steps(self, n: int, log) -> dict:
        """The first ``n`` steps through the window's own calls, and the
        program's readings (``reference/train.py``); the launches of the
        attention kernels a step are checked against one forward and one
        backward a layer (no recompute VJP, which launches neither)."""
        optimizer = self.state.optimizer
        b1 = optimizer.param_groups[0]["betas"][0]
        model = self.state.model
        out = {"loss": [], "grad_norm": {}, "change_norm": {}}
        losses, launches = [], []
        for t in range(1, n + 1):
            before = dict(self.att.LAUNCHES)
            losses.append(self.train_step(self.next_batch()))
            launches.append({k: v - before[k] for k, v in self.att.LAUNCHES.items()
                             if v != before[k]})
            if t == 1:
                with torch.no_grad():
                    for name, p in model.named_parameters():
                        # no state: the optimizer was never given this gradient
                        m = optimizer.state.get(p, {}).get("exp_avg", torch.zeros(()))
                        out["grad_norm"][name] = torch.linalg.vector_norm(m / (1 - b1)).item()
        out["loss"] = [x.item() for x in losses]
        w0 = weights.make(reference_lm.param_spec(self.cfg), self.seed, self.device)
        with torch.no_grad():
            for name, p in model.named_parameters():
                out["change_norm"][name] = torch.linalg.vector_norm(p - w0[name]).item()
        del w0
        layers = self.cfg["num_hidden_layers"]
        want = ({"flash_attn_fwd": layers, "flash_attn_bwd": layers}
                if torch.device(self.device).type == "cuda" else {})
        log(f"[lm_train] attention kernel launches a step: {launches} (expected {want}: "
            f"one forward and one backward a layer, no recompute VJP)")
        out["path_mismatch"] = sum(d != want for d in launches)
        return out

    def close(self):
        self.batches.close()
        self.stop.set()
        self.producer.join()
        self.state = self.step_fn = self.batches = self.feed = None


def build(cfg: dict, mix: dict, seed: int, device, log) -> Session:
    return Session(cfg, mix, seed, device, log)
