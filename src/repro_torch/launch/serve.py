"""Serving entry point: batched prefill + greedy decode with KV / state
caches, the port of ``repro/launch/serve.py`` on one CUDA device.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \
        --reduced --batch 4 --prompt-len 32 --gen 16

Params come from ``init_params(cfg, PRNGKey(seed))`` and the prompts from
``np.random.default_rng(seed)``, as the reference's; the vlm and audio
families get zero vision / audio embeddings. ``serve(args, device="cpu")``
runs on the CPU.
"""
from __future__ import annotations

import argparse
import time
from typing import List, NamedTuple

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.configs import get_config
from repro_torch.fl.runtime import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import transformer as tf


class Served(NamedTuple):
    tokens: torch.Tensor        # (B, gen + 1): the prefill's greedy token,
    #                             then one a decode step
    logits: List[torch.Tensor]  # (B, 1, V) each: the prefill's, then each
    #                             decode step's; the last is the reference's
    #                             final ``logits``
    prefill_s: float
    decode_s: float


def _wall(dev: torch.device) -> float:
    """The host clock, the device drained first."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def serve(args, device="cuda", cfg=None) -> Served:
    """Prefill ``--batch`` random prompts of ``--prompt-len`` tokens, then
    decode ``--gen`` tokens greedily; print as the reference does and
    return what was served. ``cfg`` replaces ``--arch`` / ``--reduced``."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    params = tf.init_params(cfg, trandom.PRNGKey(args.seed, dev))
    rng = np.random.default_rng(args.seed)
    b = args.batch
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (b, args.prompt_len)),
        dtype=torch.int32, device=dev)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.zeros(
            (b, cfg.n_vision_tokens, cfg.vision_dim), dtype=torch.float32,
            device=dev)
    if cfg.family == "audio":
        batch["audio_embeds"] = torch.zeros(
            (b, cfg.n_audio_frames, cfg.d_model), dtype=torch.float32,
            device=dev)

    total = args.prompt_len + args.gen
    with torch.no_grad():
        # prefill populates a fresh right-sized cache; recurrent families
        # carry state, attention families carry (layers, B, S, K, hd) kv
        t0 = _wall(dev)
        logits, pf_cache = make_prefill_step(cfg)(params, batch)
        cache = tf.init_decode_cache(cfg, b, total, device=dev)
        cache = _load_prefill(cfg, cache, pf_cache, args.prompt_len)
        prefill_s = _wall(dev) - t0
        print(f"prefill {args.prompt_len} tokens: {prefill_s:.2f}s")

        decode = make_decode_step(cfg, circular=False)
        token = logits[:, -1, :].argmax(dim=-1).to(torch.int32)[:, None]
        out_tokens, out_logits = [token], [logits]
        t0 = _wall(dev)
        for i in range(args.gen):
            logits, cache = decode(params, cache, token, args.prompt_len + i)
            token = logits[:, -1, :].argmax(dim=-1).to(torch.int32)[:, None]
            out_tokens.append(token)
            out_logits.append(logits)
        decode_s = _wall(dev) - t0
    toks = torch.cat(out_tokens, dim=1)
    print(f"decoded {args.gen} x {b} tokens in {decode_s:.2f}s "
          f"({args.gen * b / max(decode_s, 1e-9):.1f} tok/s)")
    print("sample:", toks[0].cpu().numpy()[:16])
    assert not torch.isnan(logits).any()
    return Served(toks, out_logits, prefill_s, decode_s)


def _prefix(dst: torch.Tensor, src: torch.Tensor, n: int, dim: int
            ) -> torch.Tensor:
    """A copy of ``dst`` whose first ``n`` entries along ``dim`` are
    ``src``'s (``dst.at[..., :n].set(src[..., :n])``)."""
    out = dst.clone()
    out.narrow(dim, 0, n).copy_(src.narrow(dim, 0, n))
    return out


def _load_prefill(cfg, cache, pf_cache, prompt_len: int, *, mesh=None,
                  cache_len=None):
    """Copy prefill kv/state into the decode cache layout. As the
    reference's: an attention cache takes the first ``prompt_len``
    positions (the dense branch assumes ``prompt_len`` fits), and hybrid's
    ring of ``w`` slots the first ``w`` (right only for prompts within the
    window). Where ``cache`` holds a member's block of the positions of
    attention caches of ``cache_len`` (``make_decode_step``), its block on
    ``mesh`` takes the prompt's positions that fall inside it."""
    fam = cfg.family

    def pre(dst, src, n, dim):
        t = dst.shape[dim]
        if cache_len is None or t == cache_len:
            return _prefix(dst, src, n, dim)
        if n > cache_len:
            raise ValueError(f"{n} prompt positions in a cache of "
                             f"{cache_len}")
        lo = mesh.index("model") * t    # this member's first position
        m = min(n, lo + t) - lo
        return (_prefix(dst, src.narrow(dim, lo, m), m, dim) if m > 0
                else dst.clone())

    if fam in ("dense", "moe"):
        return {k: pre(cache[k], pf_cache[k], prompt_len, 2)
                for k in ("k", "v")}
    if fam == "ssm":
        return {"conv": pf_cache["conv"].to(cache["conv"].dtype),
                "ssm": pf_cache["ssm"]}
    if fam == "hybrid":
        sup = dict(cache["super"])
        for key, val in pf_cache["super"].items():
            if key.endswith("_k") or key.endswith("_v"):
                n = min(val.shape[2], cache_len or sup[key].shape[2])
                sup[key] = pre(sup[key], val, n, 2)
            else:
                sup[key] = val.to(sup[key].dtype)
        rest = []
        for c_l, p_l in zip(cache["rest"], pf_cache["rest"]):
            if isinstance(p_l, tuple) and p_l[0].ndim == 3:  # rglru state
                rest.append((p_l[0].to(c_l[0].dtype), p_l[1]))
            else:
                rest.append(tuple(pre(c, p, prompt_len, 1)
                                  for c, p in zip(c_l, p_l)))
        return {"super": sup, "rest": rest}
    if fam in ("vlm", "audio"):
        dim = 3 if fam == "vlm" else 2
        return dict(cache, **{k: pre(cache[k], pf_cache[k], prompt_len, dim)
                              for k in ("k", "v")},
                    cross_k=pf_cache["cross_k"], cross_v=pf_cache["cross_v"])
    raise ValueError(fam)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None, device="cuda") -> None:
    serve(parser().parse_args(argv), device=device)


if __name__ == "__main__":
    main()
