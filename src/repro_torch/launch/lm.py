"""LM serving launcher on PyTorch: prefill, then greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.lm [--arch qwen3-4b] \\
        [--batch 1 --prompt-len 32768 --new-tokens 16 --requests 1] \\
        [--seed 0] [--smoke] [--device cuda|cpu]

The port's counterpart of the serve cells that the reference lowers in
``launch/dryrun.py`` (``configs/lm_common.py``: ``prefill_32k`` and
``decode_32k``), run for real on one card. The model is ``--arch`` at its
published widths and full depth with bf16 serving weights, drawn by
``lm_init`` from ``--seed`` on the device (there is no checkpoint).
``--smoke`` serves the reference's smoke reduction
(``lm_common.smoke_config``) instead.

Each request: draw ``(batch, prompt-len)`` prompt tokens from the seed;
``lm_prefill`` (one ``flash_attention`` launch per layer); copy its cache
into a decode cache of ``prompt-len + new-tokens`` positions; take the
greedy argmax as the next token; run ``new-tokens`` ``lm_decode_step``\\ s,
each feeding the last argmax. Prints one JSON report: prefill ms, decode
ms per token, the generated ids, ``flash_attention`` launches and peak
device memory.

Defaults: ``prefill_32k``'s sequence with its batch cut 32 → 1 (32
sequences' bf16 cache alone is 154.6 GB), decoding on that ~32k cache,
``decode_32k``'s length with its batch cut 128 → 1. Runs on ``--device
cuda`` (default; raises without a card) or ``--device cpu`` — never the
full model on a CPU. The MoE architectures exit naming ROADMAP A11.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.configs import LM_ARCHS, LM_NOT_PORTED
from repro_torch.configs.lm_common import smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.transformer import (init_decode_cache,
                                            lm_decode_step, lm_init,
                                            lm_prefill)

WEIGHT_DTYPE = torch.bfloat16  # serving weights, as the reference's cells


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """The launcher's flags; an unknown flag or arch exits with an error."""
    p = argparse.ArgumentParser(prog="repro_torch.launch.lm")
    p.add_argument("--arch", default="qwen3-4b")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--prompt-len", type=int, default=32768)
    p.add_argument("--new-tokens", type=int, default=16)
    p.add_argument("--requests", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true")
    args = p.parse_args(argv)
    if args.arch in LM_NOT_PORTED:
        p.exit(2, f"repro_torch.launch.lm: --arch {args.arch} needs the MoE "
                  "FFN, not ported yet (ROADMAP A11)\n")
    if args.arch not in LM_ARCHS:
        p.exit(2, f"repro_torch.launch.lm: unknown --arch {args.arch}\n")
    return args


def _sync(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def serve(args: argparse.Namespace) -> dict:
    """Serve ``args.requests`` requests; returns the report."""
    dev = resolve_device(args.device)
    cfg = LM_ARCHS[args.arch]
    if args.smoke:
        cfg = smoke_config(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = lm_init(gen, cfg, dtype=WEIGHT_DTYPE)
    n_params = sum(p.numel() for p in model.parameters())
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = fa.LAUNCHES.value
    total = args.prompt_len + args.new_tokens
    requests = []
    finite = True
    for _ in range(args.requests):
        tokens = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                               generator=gen, device=dev)
        t0 = _sync(dev)
        logits, cache = lm_prefill(model, tokens, cfg)
        t1 = _sync(dev)
        dcache = init_decode_cache(cfg, args.batch, total, device=dev)
        for key in ("k", "v"):
            dcache[key][:, :, :args.prompt_len] = cache[key]
        del cache
        finite &= bool(torch.isfinite(logits).all())
        token = logits.argmax(-1)
        ids = [token]
        t2 = _sync(dev)
        for step in range(args.new_tokens):
            logits, dcache = lm_decode_step(model, token[:, None], dcache,
                                            args.prompt_len + step + 1, cfg)
            finite &= bool(torch.isfinite(logits).all())
            token = logits.argmax(-1)
            ids.append(token)
        t3 = _sync(dev)
        del dcache
        requests.append({
            "prefill_ms": (t1 - t0) * 1e3,
            "decode_ms_per_token": ((t3 - t2) * 1e3 / args.new_tokens
                                    if args.new_tokens else None),
            "generated": torch.stack(ids, 1).tolist()})
    report = {
        "arch": args.arch, "smoke": args.smoke, "device": str(dev),
        "params": n_params, "batch": args.batch,
        "prompt_len": args.prompt_len, "new_tokens": args.new_tokens,
        "requests": requests, "logits_finite": finite,
        "flash_launches": fa.LAUNCHES.value - launches0,
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None)}
    return report


def main(argv: Optional[Sequence[str]] = None) -> dict:
    report = serve(parse_args(argv))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
