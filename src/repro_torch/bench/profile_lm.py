"""Where the time of an LM request goes on the card: a prefill split into
stages, decode per token, and the device's idle share.

    PYTHONPATH=src python -m repro_torch.bench.profile_lm \\
        [--arch qwen3-4b --prompt-len 32768 --new-tokens 16] \\
        [--out chiprun_out/profile_lm.json]

The model is the launcher's (``repro_torch.launch.lm``: bf16 serving
weights from ``lm_init`` with seed 0, batch 1). After a warm-up prefill at
the full length:

1. One prefill runs stage by stage with CUDA events around each stage of
   each layer, summed over the layers: ``embed``; ``norms_rope`` (ln1,
   qk-norm, RoPE, ln2); ``qkv_o_gemm`` (the q/k/v and output projections,
   with the QKV bias and the residual add); ``flash`` (the kernel);
   ``ffn`` (the SwiGLU GEMMs with their activation, product and residual
   add); ``cache`` (the bf16 cache writes); ``unembed`` (final norm and
   logits). For an MoE arch the FFN is split instead into ``router``
   (fp32 logits, softmax, top-k, and the router stats), ``dispatch`` (the
   slots and the dispatch buffer), ``experts`` (the three batched
   products and the SiLU gate), ``combine`` (the gather back, the
   weighting, the ordered fold and the residual add) and ``shared`` (the
   shared experts and their add). The report says whether its logits
   equal ``lm_prefill``'s bit for bit, i.e. whether the split timed the
   same computation.
2. ``lm_prefill`` under ``torch.profiler``: host-clock wall, device busy
   time (the sum of device kernel and copy durations) and idle share
   ``1 - busy / wall``, and the device time by kernel name.
3. ``new-tokens`` decode steps on the prefill's cache timed on the host
   clock, then ``new-tokens`` more under the profiler for the same
   busy/idle split.

For an MoE arch the report adds the prefill's router stats
(``repro_torch.launch.lm.moe_prefill_report``).

Prints one JSON report and writes it to ``--out`` if given. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import LM_ARCHS
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch.lm import WEIGHT_DTYPE, moe_prefill_report
from repro_torch.models import moe as moe_ops
from repro_torch.models.attention import apply_rope
from repro_torch.models.transformer import (_logits, _rope,
                                            init_decode_cache,
                                            lm_decode_step, lm_init,
                                            lm_prefill)

STAGES = ("embed", "norms_rope", "qkv_o_gemm", "flash", "ffn", "router",
          "dispatch", "experts", "combine", "shared", "cache", "unembed")


class _Stages:
    """CUDA events around stages; elapsed ms summed per stage name."""

    def __init__(self, names: tuple[str, ...] = STAGES) -> None:
        self.names = names
        self.marks: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
        self._open: tuple[str, torch.cuda.Event] | None = None

    def start(self, name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._open = (name, ev)

    def stop(self) -> None:
        name, start = self._open
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.marks.append((name, start, end))

    def totals(self) -> dict[str, float]:
        """Summed ms of each stage that ran, in ``names`` order."""
        torch.cuda.synchronize()
        ran = {name for name, _, _ in self.marks}
        out = {name: 0.0 for name in self.names if name in ran}
        for name, start, end in self.marks:
            out[name] += start.elapsed_time(end)
        return out


def staged_moe(st: _Stages, h: torch.Tensor, x: torch.Tensor, m
               ) -> torch.Tensor:
    """``h + MoE(x)`` for ``x (B, S, d)`` as ``moe_apply`` computes it,
    stage by stage; the stats are kept in ``m.last_stats``."""
    b, s, d = x.shape
    cfg = m.cfg
    x = x.reshape(b * s, d)
    st.start("router")
    probs, top_w, top_e = moe_ops.moe_route(m, x, cfg)
    st.stop()
    st.start("dispatch")
    plan = moe_ops.moe_plan(top_e, cfg)
    dispatch = moe_ops.moe_dispatch(x, plan, cfg)
    st.stop()
    st.start("experts")
    y = moe_ops.moe_experts(m, dispatch)
    st.stop()
    st.start("combine")
    out = moe_ops.moe_combine(y, plan, top_w)
    st.stop()
    if cfg.n_shared:
        st.start("shared")
        out = out + moe_ops.moe_shared(m, x)
        st.stop()
    st.start("router")
    m.last_stats = moe_ops.moe_stats(probs, top_e, plan, cfg)
    st.stop()
    st.start("combine")
    h = h + out.reshape(b, s, d)
    st.stop()
    return h


@torch.no_grad()
def staged_prefill(model, tokens, cfg) -> tuple[torch.Tensor, dict]:
    """``lm_prefill`` written out stage by stage under CUDA events."""
    st = _Stages()
    b, s = tokens.shape
    st.start("embed")
    h = model.embed[tokens].to(cfg.adtype)
    cos, sin = _rope(torch.arange(s, device=tokens.device), cfg)
    st.stop()
    shape = (cfg.n_layers, b, s, cfg.n_kv, cfg.head_dim)
    cache = {"k": torch.empty(shape, dtype=torch.bfloat16, device=h.device),
             "v": torch.empty(shape, dtype=torch.bfloat16, device=h.device)}
    for i, blk in enumerate(model.layers):
        st.start("norms_rope")
        x = blk.ln1(h)
        st.stop()
        st.start("qkv_o_gemm")
        q, k, v = (x @ w.to(x.dtype) for w in (blk.wq, blk.wk, blk.wv))
        if cfg.qkv_bias:
            q = q + blk.bq.to(q.dtype)
            k = k + blk.bk.to(k.dtype)
            v = v + blk.bv.to(v.dtype)
        st.stop()
        st.start("norms_rope")
        q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
        k = k.reshape(b, s, cfg.n_kv, cfg.head_dim)
        v = v.reshape(b, s, cfg.n_kv, cfg.head_dim)
        if cfg.qk_norm:
            q, k = blk.q_norm(q), blk.k_norm(k)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        st.stop()
        st.start("flash")
        o = flash_ops.flash_attention(q, k, v, causal=True)
        st.stop()
        st.start("qkv_o_gemm")
        h = blk.out(h, o)
        st.stop()
        st.start("norms_rope")
        x = blk.ln2(h)
        st.stop()
        if cfg.moe is not None:
            h = staged_moe(st, h, x, blk.moe)
        else:
            st.start("ffn")
            g = F.silu(x @ blk.w1.to(x.dtype))
            h = h + (g * (x @ blk.w3.to(x.dtype))) @ blk.w2.to(x.dtype)
            st.stop()
        st.start("cache")
        cache["k"][i] = k
        cache["v"][i] = v
        st.stop()
    st.start("unembed")
    logits = _logits(model, h[:, -1])
    st.stop()
    return logits, st.totals()


def _device_busy_ms(prof) -> tuple[float, dict[str, float]]:
    busy_us, by_name = 0.0, defaultdict(float)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy_us += us
            by_name[e.name] += us
    top = {n: us / 1e3 for n, us in sorted(by_name.items(),
                                           key=lambda kv: -kv[1])[:8]}
    return busy_us / 1e3, top


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="repro_torch.bench.profile_lm")
    p.add_argument("--arch", default="qwen3-4b", choices=sorted(LM_ARCHS))
    p.add_argument("--prompt-len", type=int, default=32768)
    p.add_argument("--new-tokens", type=int, default=16)
    p.add_argument("--out", default=None, help="write the report here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_lm needs a CUDA device")
    dev = torch.device("cuda")
    cfg = LM_ARCHS[args.arch]
    gen = torch.Generator(device=dev).manual_seed(0)
    model = lm_init(gen, cfg, dtype=WEIGHT_DTYPE)
    tokens = torch.randint(0, cfg.vocab, (1, args.prompt_len),
                           generator=gen, device=dev)
    lm_prefill(model, tokens, cfg)
    torch.cuda.synchronize()

    staged, stage_ms = staged_prefill(model, tokens, cfg)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, cache = lm_prefill(model, tokens, cfg)
        torch.cuda.synchronize()
        prefill_wall = time.perf_counter() - t0
    prefill_busy, prefill_top = _device_busy_ms(prof)
    same = bool(torch.equal(staged, logits))
    moe = (moe_prefill_report(model, args.prompt_len)
           if cfg.moe is not None else None)

    n = args.new_tokens
    dcache = init_decode_cache(cfg, 1, args.prompt_len + 2 * n, device=dev)
    for key in ("k", "v"):
        dcache[key][:, :, :args.prompt_len] = cache[key]
    del cache
    token = logits.argmax(-1)

    def decode(first: int) -> float:
        nonlocal token
        t0 = time.perf_counter()
        for step in range(first, first + n):
            out, _ = lm_decode_step(model, token[:, None], dcache,
                                    args.prompt_len + step + 1, cfg)
            token = out.argmax(-1)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    decode_wall = decode(0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_wall = decode(n)
    decode_busy, decode_top = _device_busy_ms(prof)
    report = {
        "card": torch.cuda.get_device_name(0), "arch": args.arch,
        "prompt_len": args.prompt_len, "new_tokens": args.new_tokens,
        "prefill_stage_ms": stage_ms,
        "staged_equals_prefill": same,
        "prefill_staged_ms": sum(stage_ms.values()),
        "prefill_wall_ms": prefill_wall * 1e3,
        "prefill_device_busy_ms": prefill_busy,
        "prefill_device_idle_share": 1.0 - prefill_busy / 1e3 / prefill_wall,
        "prefill_top_device_ms": prefill_top,
        "decode_ms_per_token": decode_wall * 1e3 / args.new_tokens,
        "decode_device_busy_ms_per_token": decode_busy / args.new_tokens,
        "decode_device_idle_share": 1.0 - decode_busy / 1e3 / profiled_wall,
        "decode_top_device_ms": decode_top,
        "peak_bytes": torch.cuda.max_memory_allocated(dev),
    }
    if moe is not None:
        report["moe_prefill"] = {k: v for k, v in moe.items()
                                 if k != "expert_load_by_layer"}
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
