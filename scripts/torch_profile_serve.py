"""Where a decode step of the port's serving path spends its time, on one
card.

    python3 scripts/torch_profile_serve.py [--model llama-3.2-vision-11b|
        whisper-base] [--warm 4] [--steps 8]

Builds the serving cell of ``chip_smoke.py`` phase 18: llama-3.2-vision-11b
at its published widths cut to 10 layers in float32 (gates 0.5, seeded
normal vision embeds, a (4, 512) prompt), or whisper-base at its published
size in float32 (zero frame embeddings, a (4, 64) prompt). It prefills,
decodes ``--warm`` greedy steps, then profiles ``--steps`` more
(``torch.profiler``, CPU + CUDA activities) and prints the host clock a
step, the device's busy share, ``cudaLaunchKernel`` calls a step, the
device time of matrix products (kernels named gemm, gemv or sm90) against
the rest, and the operators with the most device and host time. Then it
measures the peak memory of the init's largest draw alone (``normal`` of
the (vocab, d_model) embedding) beside that of the whole ``init_params``.
Needs CUDA; fails without it.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from repro_torch import random as trandom  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import _load_prefill  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step)
from repro_torch.models import transformer as tf  # noqa: E402

# (depth, batch, prompt) of phase 18's cells
CELLS = {"llama-3.2-vision-11b": (10, 4, 512), "whisper-base": (None, 4, 64)}


def _peak_gb(fn) -> float:
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    del out
    torch.cuda.empty_cache()
    return peak


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="llama-3.2-vision-11b",
                    choices=sorted(CELLS))
    ap.add_argument("--warm", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_serve: CUDA is not available")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    depth, b, s = CELLS[args.model]
    cfg = dataclasses.replace(get_config(args.model), dtype="float32")
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    params = tf.init_params(cfg, trandom.PRNGKey(0, dev))
    batch = {"tokens": torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s)), dtype=torch.int32, device=dev)}
    if cfg.family == "vlm":
        for g in ("gate_attn", "gate_mlp"):
            params[f"blocks/cross/{g}"].fill_(0.5)
        gen = torch.Generator(device=dev).manual_seed(0)
        batch["vision_embeds"] = torch.randn(
            (b, cfg.n_vision_tokens, cfg.vision_dim), generator=gen,
            device=dev)
    else:
        batch["audio_embeds"] = torch.zeros(
            (b, cfg.n_audio_frames, cfg.d_model), device=dev)
    total = s + args.warm + args.steps
    decode = make_decode_step(cfg, circular=False)
    with torch.no_grad():
        logits, pf = make_prefill_step(cfg)(params, batch)
        cache = _load_prefill(cfg, tf.init_decode_cache(cfg, b, total,
                                                        device=dev), pf, s)
        del pf
        pos = s

        def step():
            nonlocal logits, cache, pos
            token = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
            logits, cache = decode(params, cache, token, pos)
            pos += 1
        for _ in range(args.warm):
            step()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    mm_us = sum(e.self_device_time_total for e in kernels
                if any(t in e.key.lower() for t in ("gemm", "gemv", "sm90")))
    n = args.steps
    print(f"{cfg.name} ({cfg.n_layers} layers, {cfg.dtype}), decode of "
          f"({b}, 1) over a {total}-slot cache: host {wall / n * 1e3:.3f} ms "
          f"a step; device busy {device_us / 1e3 / n:.3f} ms a step = "
          f"{device_us / 1e6 / wall:.3f} of the wall clock; matrix products "
          f"{mm_us / 1e3 / n:.3f} ms a step ({mm_us / max(device_us, 1):.3f} "
          f"of the device time)", flush=True)
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    print(f"cudaLaunchKernel: {launches / n:.0f} a step", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"device {e.self_device_time_total / 1e3 / n:9.3f} ms a step "
              f"x{e.count // n:<6d} {e.key[:100]}", flush=True)
    for e in sorted((e for e in events if e.device_type != DeviceType.CUDA),
                    key=lambda e: -e.self_cpu_time_total)[:12]:
        print(f"host   {e.self_cpu_time_total / 1e3 / n:9.3f} ms a step "
              f"x{e.count // n:<6d} {e.key[:100]}", flush=True)
    print(f"logits finite: {bool(torch.isfinite(logits).all())}")
    del params, cache, logits
    draw = _peak_gb(lambda: trandom.normal(trandom.PRNGKey(0, dev),
                                           (cfg.vocab_size, cfg.d_model)))
    whole = _peak_gb(lambda: tf.init_params(cfg, trandom.PRNGKey(0, dev)))
    print(f"init peak: normal of ({cfg.vocab_size}, {cfg.d_model}) alone "
          f"{draw:.3f} GB ({4 * cfg.vocab_size * cfg.d_model / 1e9:.3f} GB "
          f"of float32 out); init_params {whole:.3f} GB on {smi}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
