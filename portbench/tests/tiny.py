"""A copy of the benchmark with tiny cells added as new files and new
entries in its ``BENCHMARK.json``, for runs on the CPU.  The tiny
configurations compute in float32: the CPU's bfloat16 kernels are not the
card's, and a tiny batch's batch norm magnifies their rounding."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_LM = {
    "name": "tiny-lm", "source": "a tiny decoder of deepseek-llm-7b's shape",
    "vocab_size": 512, "hidden_size": 64, "intermediate_size": 160,
    "num_attention_heads": 2, "num_key_value_heads": 2, "head_dim": 32,
    "num_hidden_layers": 2, "max_position_embeddings": 64, "rms_norm_eps": 1e-06,
    "rope_theta": 10000.0, "hidden_act": "silu", "tie_word_embeddings": False,
    "initializer_range": 0.02, "compute_dtype": "float32", "master_dtype": "float32",
    "optimizer": {"name": "adamw", "lr": 0.0003, "betas": [0.9, 0.999], "eps": 1e-08,
                  "weight_decay": 0.0001},
}
TINY_RESNET = {
    "name": "tiny-resnet", "source": "resnet50-imagenet's shape at width 8",
    "image_size": 64, "num_classes": 10, "width": 8, "stage_sizes": [3, 4, 6, 3],
    "bn_momentum": 0.9, "bn_epsilon": 1e-05, "weight_decay": 0.0001,
    "compute_dtype": "float32", "norm_dtype": "float32", "master_dtype": "float32",
    "optimizer": {"name": "sgd", "lr": 0.1, "momentum": 0.9, "nesterov": True},
}
MIXES = {
    "tiny-zipf": {"kind": "token_rows", "batch": 4, "seq_len": 64, "zipf_a": 1.5,
                  "pool_batches": 6, "queued_steps": 4, "prefetch": 2},
    "tiny-images": {"kind": "images", "batch": 16, "image_size": 64, "pool_batches": 4},
}
# the cells' own limits, so that the tiny runs are judged as the cells are
CELLS = {
    "tiny-lm-train": ("tiny-lm", "tiny-zipf", "lm_train", "lm7b-train-s4096"),
    "tiny-resnet-train": ("tiny-resnet", "tiny-images", "image_train",
                          "resnet50-train-b256"),
}


def _write(path: Path, data: dict) -> None:
    path.write_text(json.dumps(data, indent=1))


def tiny_bench(dest: Path) -> Path:
    """``dest`` holding ``BENCHMARK.json`` and ``portbench/`` with the tiny
    cells added; returns ``dest``."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = dest / "portbench"
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    for cfg in (TINY_LM, TINY_RESNET):
        _write(bench / "configs" / f"{cfg['name']}.json", cfg)
    for name, mix in MIXES.items():
        _write(bench / "mixes" / f"{name}.json", mix)
    for cell, (config, mix, entry, like) in CELLS.items():
        limits = json.loads((bench / "workloads" / f"{like}.json").read_text())["limits"]
        _write(bench / "workloads" / f"{cell}.json",
               {"name": cell, "config": config, "traffic": mix, "entry": entry, "chips": 1,
                "builds": [], "proof_steps": 3, "limits": limits, "why": "a CPU test"})
        spec["workloads"].append({"name": cell, "config": config, "traffic": mix,
                                  "chips": 1, "why": "a CPU test"})
        for metric in spec["end_to_end"] + spec["per_layer"]:
            if like in metric.get("workloads", []):
                metric["workloads"].append(cell)
    _write(dest / "BENCHMARK.json", spec)
    return dest
