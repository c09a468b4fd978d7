#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device   — the card's name, capability (9, 0) required, and
               ``nvidia-smi --query-gpu=name,power.limit``;
2. build    — every ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a, all
               in parallel, into the git-ignored ``build/kernels``;
3. kernels  — each of the four kernels against its plain PyTorch version on
               the card at ViT-Base shapes (bitwise, or within the bound
               stated below), and its time beside its bound, the plain
               version's time and a library call's time where one computes
               the same function: ``noisy_sgd_update`` (one leaf, the flat
               buffer, and the one-launch ``tree_noisy_update`` over all 23
               leaves against the per-leaf plain update for every noise
               kind and momentum form; the Threefry and the noise-free step
               timed, one launch per step), ``clip_accum_inplace``,
               ``ghost_norm_dense`` (the head's shape on the main path, the
               block shapes a forced direct path gives it, a ragged shape
               and the DenseLM direct-path shape; bf16, and f32 at three of
               them; reruns bit-identical, one launch per call, and one
               device kernel per call as ``torch.profiler`` sees it) and the
               resident ``clip_accum``;
4. fit      — ``PrivacySession.fit()`` of full-width ViT-Base: 3 Poisson
               DP-SGD steps with ``masked_fused_stream``, ``masked_ghost``
               and ``masked_bk`` and 1 with ``masked_fused``; every kernel's
               launch counter is set to 0 just before each run and read just
               after, and each run must launch the kernels its engine
               reaches, ``noisy_sgd_update`` once per step.  Then, on one
               fixed physical batch: ``masked_pe`` against
               ``masked_fused_stream`` (at the sized tile, and at a
               forced smaller tile that pads the batch and carries the
               accumulator over several tiles), each streaming call's peak
               memory against the tile-sizing rule's model of it, one
               streaming call at a batch where the rule binds; ``masked_pe``
               against ``masked_fused`` (bitwise), ``masked_ghost``,
               ``masked_bk`` and the streaming engine's ``"ghost"`` norm
               source; every dense layer's ghost norm through the kernel
               (forced direct path) against the einsum (forced ghost path);
               one ``accumulate`` per engine timed against ``nonprivate``
               (the paper's overhead ratio; here and in every later phase
               its first and last timed calls bit-identical, what a
               bitwise resume needs); and the training CLI with
               ``masked_pe`` and each new engine;
5. denselm  — full-width qwen2-0.5b (630,167,424 params) at 1,024 tokens,
               after the ViT session is freed: ``ghost_norm_dense`` at its
               direct-path shapes (4, 1024, 896, 896) and (4, 1024, 896,
               128), the one-launch ``tree_noisy_update`` over the 630M-param
               view against the per-leaf plain update (and timed),
               ``clip_accum_inplace`` at the sized stream tile and
               ``clip_accum`` at the physical batch of 4; ``fit()`` with
               ``masked_bk``, ``masked_ghost`` and ``masked_fused_stream``
               (2 steps each) and ``masked_fused`` (1 step), each launching
               ``noisy_sgd_update`` once per step and ``ghost_norm_dense``
               exactly 96 times per norm pass (wq, wk, wv, wo of 24 layers);
               on one physical batch the record engines against
               ``masked_pe`` under DenseLM's own limits (``DENSELM_LIMITS``);
               the host cost of one norm pass; one accumulate per engine
               against ``nonprivate``; and the training CLI at 1,024 tokens;
6. lifecycle — full-width ViT-Base again: the noise-only body of
               ``noisy_sgd_update`` (the unfused update's draw) against
               ``threefry_normal`` on every leaf, one launch per call, timed
               beside its bound; one momentum-SGD update through the fused
               kernel and through ``fuse=False`` from the same state and
               seeds, bitwise; ``masked_fused`` at 4 microbatches against 1
               (``clip_accum`` once per microbatch); 2-step fits with AdamW
               and with Nesterov, each launching the noise-only body once
               per step and the fused form never; a 4-step
               ``masked_fused_stream`` fit with ``checkpoint_async`` every 2
               steps and a fresh session restored from step 2, bitwise
               (params sha256, ε ``float.hex``), with each save's size, copy
               and commit times and the fit's checkpoint waits; the chaos
               harness killing subprocess runs at ``ckpt/mid_d2h``,
               ``ckpt/after_state_before_manifest`` and ``fit/step_end``,
               each resumed bitwise from a snapshot; and the paper-protocol
               twin's four engines at full width;
7. ssm      — full-width mamba2-1.3b (1,446,505,472 params) and
               zamba2-1.2b (1,170,313,344) at 1,024 tokens, after the
               lifecycle: ``ghost_norm_dense`` at mamba2's forced-direct
               and zamba2's shared-block shapes (T_eff = 6,144), the
               one-launch update and the clip kernels at each model's flat
               length (a physical batch of 1); ``fit()`` per engine (mamba2:
               ``masked_pe``, ``masked_ghost``, ``masked_bk``,
               ``masked_fused_stream`` 2 steps each, ``masked_fused`` and
               ``nonprivate`` 1; zamba2: ghost, BK and the stream 2 each,
               ``nonprivate`` 1), ``ghost_norm_dense`` launched 0 (mamba2)
               and 7 (zamba2) times per norm pass; the chunked SSD scan on
               one layer's real activations against the per-token
               recurrence and a smaller chunk; on one physical batch
               ``masked_fused`` and the stream at tile = batch bitwise
               against ``masked_pe``, the record engines under
               ``MAMBA2_LIMITS`` / ``DENSELM_LIMITS``, and every dense
               layer's forced direct path against its Gram path (mamba2's
               projections launch the kernel there); one norm pass; one
               accumulate per engine against ``nonprivate``, after one with
               every example masked out that must add exactly 0;
8. moe      — full-width olmoe-1b-7b at 3 of its 16 layers
               (1,464,744,704 params) and deepseek-v2-lite-16b at 2 of 27
               (its dense layer and one MoE layer; 1,085,287,424) at 1,024
               tokens, after the SSM phase: ``ghost_norm_dense`` at the
               router's and MLA's RoPE key's shape (B, 1,024, 2,048, 64),
               the update and the clip kernels at each model's flat length;
               ``fit()`` with ``masked_pe``, ``masked_ghost``,
               ``masked_bk`` and ``masked_fused_stream`` (2 steps each),
               ``masked_fused`` and ``nonprivate`` (1), the kernel launched
               3 times per norm pass (olmoe's routers; deepseek's router and
               2 ``wkr``); on one physical batch the experts the batched and
               the per-example forwards select (any difference printed),
               ``masked_fused`` and the stream at tile = batch bitwise
               against ``masked_pe``, the record engines under
               ``MOE_LIMITS`` and every dense layer's forced direct path
               against its Gram path; one norm pass; one accumulate per
               engine against ``nonprivate``, after one with every example
               masked out that must add exactly 0; and BK's embedding
               grad run three times on tokens that all repeat,
               bit-identical;
9. frontend — full-width, full-depth whisper-base (97,241,088 params) at
               1,500 frames and 448 decoder tokens, a physical batch of 8,
               and full-width llama-3.2-vision-90b cut to 2 layers with
               ``cross_every`` 2 (one RoPE self-attention layer, one gated
               cross-attention layer; 3,823,149,057 params, the first flat
               buffer above 2^31 elements) at 1,024 text tokens and 1,601
               image tokens, a physical batch of 1, its gates set to
               ``VLM_GATE`` (the reference initialises them to 0, which
               zeroes the cross attention's and ``proj``'s gradients), after
               the MoE phase: ``ghost_norm_dense`` at whisper's three
               direct-path shapes (ragged T = 1,500), the update and both
               clip kernels at whisper's flat length and over the VLM's
               whole 3.82G buffer, held against their plain versions on the
               leaf that holds element 2^31 and on the buffer's tail;
               ``fit()`` with every engine (whisper: ``masked_pe``,
               ``masked_ghost``, ``masked_bk``, ``masked_fused_stream`` 2
               steps each, ``masked_fused`` and ``nonprivate`` 1; the VLM 1
               step each, without momentum), ``ghost_norm_dense`` launched
               48 times per whisper norm pass (every encoder dense and the
               decoder's cross-attention ``wk``/``wv``) and 0 on the VLM;
               on one physical batch ``masked_fused`` and the stream at
               tile = batch bitwise against ``masked_pe``, the record
               engines under ``FRONTEND_LIMITS``, every dense layer's
               forced direct path against its Gram path; one norm pass
               with the kernel's share of its device time; one accumulate
               per engine against ``nonprivate``, after one with every
               example masked out that must add exactly 0.

The line before the last lists the kernels as JSON (launches summed over
every ``fit()``, ViT's, DenseLM's, the lifecycle's, the SSM, MoE and
frontend phases', the noise-only body as ``noisy_sgd_update``'s
``noise_only`` record; times at ViT-Base's main-path shapes, the other
phases' in the record); the last line is ``{"ok": true, "device":
{...}}``.  The full record goes to
``chiprun_out/chip_smoke.json``.  Without a CUDA device, or run outside a
checkout of the repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the card's published peaks (NVIDIA H100 SXM data sheet, dense rates); the
# int32 rate is 64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost (Hopper
# white paper).  A product of two bf16 values is exact in f32, so bf16
# operands multiplied with f32 accumulation count at the tensor cores' bf16
# rate; f32 operands at the rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
I32_OPS_PER_S = 16.7e12

NORMAL_ULP_BOUND = 2          # in-kernel normals against the plain version
# past this flat length (the first element past int32 indexing) the
# update's and the clip kernels' checks still run each kernel over the
# whole buffer, but hold it against its plain version on windows
# (held_windows), one of which straddles it: whole-buffer copies (15.3 GB
# each at the VLM's 3.82G) would not fit beside the operands.  The clip
# kernels are also held on the buffer's last BIG_FLAT_TAIL elements (the
# alignment pad and the last leaf's end)
BIG_FLAT_AT = 2 ** 31
BIG_FLAT_TAIL = 1 << 24
# cuBLAS's gemv takes at most 2^31 - 1 rows (addmv_ and coef @ g raise
# past it): the clip kernels' yardstick changes form there (clip_library_fn)
GEMV_MAX_ROWS = 2 ** 31 - 1
# masked_fused_stream at a tile below the batch against masked_pe at the
# whole batch, as a share of max |acc|: a row's per-example gradient bits
# depend on the vmap width, and the bf16 activations turn a last-bit f32
# difference into a bf16 rounding step (2^-8); the same bound as the CPU
# tests' bf16 per-example gradients.  The engine's own arithmetic is held
# bitwise against the tile-wise fold (tilewise_fold) instead
STREAM_PE_REL_TOL = 5e-2
# a forced tile below the physical batch of 32: three tiles, the last one
# padded by 4 copies of example 0 with mask 0
STREAM_SMALL_TILE = 12
# ops per element of the Threefry momentum update: 7 f32 ops of the update
# + 8 of Box-Muller (log, sqrt and cos counted as one each); 20 rounds of
# add, rotate (one funnel shift) and xor, 5 key injections of two adds, the
# two counter adds and the two shifts of bits_to_normal
THREEFRY_UPDATE_F32_OPS = 15
THREEFRY_I32_OPS = 20 * 3 + 5 * 2 + 2 + 2
# ghost_norm_dense against its plain version, relative to each n_b: both sum
# in f32, in other orders (the kernel by 128 x 128 tiles of tensor-core
# products for bf16, by 64 x 64 tiles and T slabs of 32 for f32)
GHOST_NORM_REL_TOL = 1e-5
# ViT-Base's dense shapes (B, T, din, dout) at a physical batch of 32: the
# head (T = 1 after (B, 768) -> (B, 1, 768)) takes the kernel on the main
# path; the block denses take it when the direct path is forced.  "ragged":
# din and dout off every tile and din off 8, T off the slab; "denselm": the
# direct path of qwen2-0.5b's 896-wide denses at T = 4096 (T^2 > din dout)
GHOST_NORM_SHAPES = {"head": (32, 1, 768, 100),
                     "attn_qkvo": (32, 197, 768, 768),
                     "mlp_w1": (32, 197, 768, 3072),
                     "mlp_w2": (32, 197, 3072, 768),
                     "ragged": (3, 197, 100, 72),
                     "denselm": (4, 4096, 896, 896)}
# the shapes also checked with f32 inputs (the f32-activation configurations)
GHOST_NORM_F32 = ("head", "attn_qkvo", "ragged")
# masked_ghost / masked_bk / the "ghost" stream norm source against
# masked_pe on one physical batch of full-width ViT-Base (bf16 activations),
# the summed gradient (a) as a share of max |acc| and (b) per leaf, as a
# share of that leaf's own max |acc|, floored at LEAF_FLOOR of max |acc| so
# a leaf whose true gradient is zero (the key bias: softmax ignores it) is
# held to rounding noise; a leaf that is zero or wrong shows as O(1).
# masked_ghost: its reweighted backward rounds coef-scaled bf16 cotangents
# where masked_pe rounds unscaled ones (1.3e-2 of max |acc| and 1.3e-2 worst
# leaf on the reduced ViT in bf16 on the CPU; 1.9e-2 of max |acc| on the
# card).  masked_bk: its sums are f32 where masked_pe rounds the bias and
# gain grads of each example to bf16 (1.6e-4 and 3.9e-3, one bf16 step, on
# the CPU; 4.7e-4 of max |acc| on the card).  The "ghost" stream source:
# masked_pe's own grads under coefficients from other norms (5.9e-7 on the
# card).  The per-example norms relative: the same bf16 dY on both sides
# (2e-6 on the CPU, 1.3e-6 on the card).  "forced": every dense layer's
# ghost norm through the kernel against the einsum path, relative: the same
# f32 products summed in other orders
LEAF_FLOOR = 1e-3
VIT_LIMITS = {
    "pe": {"masked_ghost": 5e-2, "masked_bk": 5e-3,
           "masked_fused_stream_ghost": 1e-4},
    "leaf": {"masked_ghost": 1e-1, "masked_bk": 2e-2,
             "masked_fused_stream_ghost": 1e-3},
    "norms": 1e-3, "forced": 1e-4}

# phase 5: full-width qwen2-0.5b (24 layers, d 896, 14 heads, 2 KV heads,
# d_ff 4864, vocab 151,936, bf16 activations, f32 params) at 1,024 tokens
DENSELM_ARCH = "qwen2-0.5b"
DENSELM_PARAMS = 630_167_424
DENSELM_TRAIN = dict(n_data=64, q=0.125, physical_batch=4, target_eps=8.0,
                     seq_len=1024, smoke=False)
# at T = 1,024 (T^2 = 1,048,576) the Mixed-Ghost rule sends wq, wo
# (896 x 896) and wk, wv (896 x 128) of every layer to the kernel; the
# SwiGLU denses (896 x 4864) and the head (896 x 151,936) take the Gram path
DENSELM_DIRECT_PER_LAYER = 4
DENSELM_GHOST_SHAPES = {"denselm_wq_wo": (4, 1024, 896, 896),
                        "denselm_wk_wv": (4, 1024, 896, 128)}
# DenseLM's own limits for the record engines against masked_pe on one
# physical batch, set before its first run on the card from the CPU's bf16
# measurements (compare_record_engines' values, on a physical batch
# of 4 of reduced qwen2-0.5b at T = 128 and of a two-layer cut at full
# width, d 896, with a vocab of 4,096 at T = 256; seeds 0 and 1) and from
# the card-over-CPU ratios the ViT showed (ghost: 1.5x of max |acc|, 6x on
# the worst leaf; BK: 3x of max |acc|, 0.7x on the worst leaf):
# * masked_ghost: 9.3e-3 to 1.0e-2 of max |acc| on the CPU, so about 1.5e-2
#   expected: 5e-2; worst leaf 1.2e-2 to 1.6e-2 (the layer norms' gains, the
#   key bias, the embedding), so about 1e-1 expected: 2e-1, still 5x below
#   the O(1) of a zeroed or wrong leaf;
# * masked_bk: 6.1e-4 to 1.9e-3 of max |acc|, so about 6e-3 expected (above
#   the ViT's 5e-3): 2e-2; worst leaf 2.5e-3 to 4.5e-3: 2e-2;
# * the "ghost" stream source: 7.7e-7 to 1.6e-6, worst leaf 1.0e-6 to
#   2.3e-6: the ViT's 1e-4 and 1e-3;
# * the norms: 1.0e-6 to 1.9e-6 relative: the ViT's 1e-3;
# * the forced direct path against the Gram path per dense layer: 4.3e-7
#   at T = 128 and 2.3e-6 at T = 256 (it grows with T): the ViT's 1e-4
DENSELM_LIMITS = {
    "pe": {"masked_ghost": 5e-2, "masked_bk": 2e-2,
           "masked_fused_stream_ghost": 1e-4},
    "leaf": {"masked_ghost": 2e-1, "masked_bk": 2e-2,
             "masked_fused_stream_ghost": 1e-3},
    "norms": 1e-3, "forced": 1e-4}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters: int) -> float:
    """Host microseconds per call of ``fn`` (the wrapper's own work and the
    launch), enqueued back to back after a synchronise; the device catches
    up afterwards."""
    import torch
    fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / iters
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return us


def bound_ms(nbytes: float, f32_ops: float = 0.0, i32_ops: float = 0.0,
             bf16_ops: float = 0.0):
    """(least time in ms, "bytes" | "operations") for the work."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (f32_ops / F32_OPS_PER_S + i32_ops / I32_OPS_PER_S
             + bf16_ops / BF16_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def max_ulp(a, b) -> int:
    """Largest distance in float32 ULPs (ordered bit patterns)."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def same_bits(a, b) -> bool:
    import torch
    return bool(torch.equal(a.contiguous().view(torch.int32),
                            b.contiguous().view(torch.int32)))


def host_buffer(n: int):
    """An f32 host buffer of n elements, page-locked when there is a card:
    a 15 GB copy to or from pageable memory takes several seconds, to a
    locked one well under one."""
    import torch
    return torch.empty(n, dtype=torch.float32,
                       pin_memory=torch.cuda.is_available())


# elements per piece when a device tensor is compared with a host copy
COMPARE_PIECE = 1 << 28


def same_bits_as_host(dev_t, host_t) -> bool:
    """``same_bits`` of a device tensor and a host copy of it, the host copy
    brought back COMPARE_PIECE elements at a time (one piece's room on
    the card)."""
    flat_d, flat_h = dev_t.reshape(-1), host_t.reshape(-1)
    if flat_d.numel() != flat_h.numel():
        return False
    return all(same_bits(flat_d[i:i + COMPARE_PIECE],
                         flat_h[i:i + COMPARE_PIECE].to(flat_d.device))
               for i in range(0, flat_d.numel(), COMPARE_PIECE))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def check_noisy_update(view, device, timer, seed=(0x1234, 0xBEEF)):
    """noisy_sgd_update on the largest leaf and on the full flat buffer."""
    import torch
    from repro_torch.kernels import noisy_update as nu

    gen = torch.Generator(device=device).manual_seed(1)
    largest = max(range(len(view.names)), key=lambda i: view.sizes[i])
    checks = {}
    max_err = 0.0
    for label, n in ((view.names[largest], view.sizes[largest]),
                     ("flat", view.total)):
        r = lambda: torch.randn(n, generator=gen, device=device)
        p0, a, z, m0 = r(), r(), r(), r()
        c = {}
        # Threefry bits: the kernel's device function vs threefry2x32
        k0, k1 = nu.threefry_bits(seed, n, device)
        c0 = torch.arange(n, dtype=torch.int64, device=device)
        r0, r1 = nu.threefry2x32(seed[0], seed[1], c0, torch.zeros_like(c0))
        c["threefry_bits_bitwise"] = bool(torch.equal(k0, r0)
                                          and torch.equal(k1, r1))
        assert c["threefry_bits_bitwise"], f"{label}: Threefry bits differ"
        del k0, k1, r0, r1, c0
        # normals: p=0, acc=0, sigma_c=1, L=1, lr=-1 makes p exactly z
        zk = torch.zeros(n, device=device)
        nu.noisy_sgd_update(zk, torch.zeros(n, device=device), None, 1.0,
                            1.0, -1.0, seed=seed)
        zp = nu.threefry_normal(seed, n, device)
        c["normal_max_ulp"] = max_ulp(zk, zp)
        c["normal_max_abs"] = float((zk - zp).abs().max())
        assert c["normal_max_ulp"] <= NORMAL_ULP_BOUND, (label, c)
        del zk, zp
        for mom in (0.0, 0.9):
            for kind in ("operand", "none", "threefry"):
                pk, pp = p0.clone(), p0.clone()
                mk = m0.clone() if mom else None
                mp = m0.clone() if mom else None
                noise = z if kind == "operand" else None
                sd = seed if kind == "threefry" else None
                args = (2.3, 64.0, 1e-3)
                nu.noisy_sgd_update(pk, a, noise, *args, momentum_buf=mk,
                                    momentum=mom, seed=sd)
                zz = nu.threefry_normal(sd, n, device) if sd else noise
                sc, inv_l, lr, mu = nu.update_scalars(*args, mom)
                nu.noisy_sgd_update_plain(pp, a, zz, sc, inv_l, lr, mp, mu)
                key = f"{kind}_mom{mom}"
                err = float((pk - pp).abs().max())
                if mom:
                    err = max(err, float((mk - mp).abs().max()))
                bitwise = same_bits(pk, pp) and (not mom or same_bits(mk, mp))
                c[key] = {"bitwise": bitwise, "max_abs_err": err}
                if kind != "threefry":
                    assert bitwise, f"{label} {key}: not bitwise {err}"
                else:
                    # the normals may differ by NORMAL_ULP_BOUND ULPs; scaled
                    # by lr * sigma_c / L that stays below p's rounding
                    assert err <= 1e-6, f"{label} {key}: {err}"
                max_err = max(max_err, err)
        checks[label] = c
        del p0, a, z, m0
    checks["tree"], tree_err = check_tree_noisy_update(view, device, seed)
    max_err = max(max_err, tree_err)
    timing, step_checks = time_tree_update(view, device, timer, seed)
    checks.update(step_checks)
    return checks, max_err, timing


def time_tree_update(view, device, timer, seed=(0x1234, 0xBEEF)):
    """The main path's call, one launch per step with in-kernel Threefry
    noise and momentum over every leaf of ``view``, timed beside its bound
    and the per-leaf plain update; its launches and device kernels per
    step, its host work, and the times of the step without momentum and
    without noise."""
    import torch
    from repro_torch.kernels import noisy_update as nu

    gen = torch.Generator(device=device).manual_seed(1)
    checks = {}
    params = {nm: torch.randn(view.shapes[i], generator=gen, device=device)
              for i, nm in enumerate(view.names)}
    acc = torch.randn(view.total, generator=gen, device=device)
    mom = torch.zeros(view.total, device=device)

    def kernel_step(seeds=seed, mu=0.9):
        nu.tree_noisy_update(params, acc, seeds, 2.3, 64.0, 1e-3, view=view,
                             momentum_buf=mom if mu else None, momentum=mu)

    sc, inv_l, lr, mu32 = nu.update_scalars(2.3, 64.0, 1e-3, 0.9)

    def plain_step():
        for i, nm in enumerate(view.names):
            o, n = view.offsets[i], view.sizes[i]
            nu.noisy_sgd_update_plain(
                params[nm].view(-1), acc[o:o + n],
                nu.threefry_normal(nu.leaf_seed(seed, i), n, device), sc,
                inv_l, lr, mom[o:o + n], mu32)

    n_par = view.n_params
    bms, by = bound_ms(20.0 * n_par, THREEFRY_UPDATE_F32_OPS * n_par,
                       THREEFRY_I32_OPS * n_par)
    before = nu.noisy_sgd_update.launches
    kernel_step()
    checks["launches_per_step"] = nu.noisy_sgd_update.launches - before
    if device.type == "cuda":
        assert checks["launches_per_step"] == 1, checks
        checks["device_kernels_per_step"] = device_kernels(kernel_step)
        assert checks["device_kernels_per_step"] is None or len(
            checks["device_kernels_per_step"]) == 1, checks
    # the plain step takes seconds past BIG_FLAT_AT: one warm-up, one call
    big = view.total > BIG_FLAT_AT
    timing = {"ms": timer(kernel_step, 20),
              "plain_ms": timer(plain_step, 1 if big else 3,
                                warmup=1 if big else 2),
              "bound_ms": bms, "bound_by": by, "library_ms": None}
    checks["host_us_per_step"] = host_us(kernel_step, 20)
    # the step without momentum (p and acc read, p written: the form of
    # the sessions without momentum)
    checks["no_momentum_ms"] = timer(lambda: kernel_step(mu=0.0), 20)
    checks["no_momentum_bound_ms"] = bound_ms(
        12.0 * n_par, (THREEFRY_UPDATE_F32_OPS - 2) * n_par,
        THREEFRY_I32_OPS * n_par)[0]
    # the same step without noise: p, acc and m read, p and m written, the
    # same 20 B/param as the Threefry step: what the in-kernel Threefry and
    # Box-Muller cost on top of the memory traffic
    checks["noise_free_ms"] = timer(lambda: kernel_step(None), 20)
    checks["noise_free_bound_ms"] = bound_ms(20.0 * n_par)[0]
    return timing, checks


def check_tree_noisy_update(view, device, seed, leaves=None):
    """The one-launch tree_noisy_update over every leaf of ``view`` against
    the per-leaf plain update on ``leaves`` (leaf indices; every leaf by
    default): each noise kind, with and without momentum; bitwise for the
    operand and noise-free forms, the Threefry form within the normals'
    bound (params and momentum to 1e-6).  The kernel updates one set of
    buffers in place, kind after kind; the plain update starts from copies
    of the held leaves taken just before each call."""
    import torch
    from repro_torch.kernels import noisy_update as nu

    gen = torch.Generator(device=device).manual_seed(5)
    params = {nm: torch.randn(view.shapes[i], generator=gen, device=device)
              for i, nm in enumerate(view.names)}
    acc = torch.randn(view.total, generator=gen, device=device)
    z = torch.randn(view.total, generator=gen, device=device)
    mom = torch.randn(view.total, generator=gen, device=device)
    leaves = range(len(view.names)) if leaves is None else leaves
    spans = {i: (view.offsets[i], view.offsets[i] + view.sizes[i])
             for i in leaves}
    args = (2.3, 64.0, 1e-3)
    res = {"held_leaves": [view.names[i] for i in leaves]}
    max_err = 0.0
    for mu in (0.0, 0.9):
        sc, inv_l, lr, mu32 = nu.update_scalars(*args, mu)
        for kind in ("operand", "none", "threefry"):
            held = {i: (params[view.names[i]].reshape(-1).clone(),
                        mom[a:b].clone() if mu else None)
                    for i, (a, b) in spans.items()}
            nu.tree_noisy_update(
                params, acc, seed if kind != "none" else None, *args,
                view=view, momentum_buf=mom if mu else None, momentum=mu,
                noise=z if kind == "operand" else None)
            err, bitwise = 0.0, True
            for i, (a, b) in spans.items():
                pp, mp = held.pop(i)
                zz = (z[a:b] if kind == "operand" else
                      nu.threefry_normal(nu.leaf_seed(seed, i), b - a,
                                         device)
                      if kind == "threefry" else None)
                nu.noisy_sgd_update_plain(pp, acc[a:b], zz, sc, inv_l, lr,
                                          mp, mu32)
                pk = params[view.names[i]].reshape(-1)
                err = max(err, float((pk - pp).abs().max()))
                bitwise = bitwise and same_bits(pk, pp)
                if mu:
                    err = max(err, float((mom[a:b] - mp).abs().max()))
                    bitwise = bitwise and same_bits(mom[a:b], mp)
                del pp, mp, zz
            key = f"{kind}_mom{mu}"
            res[key] = {"bitwise": bitwise, "max_abs_err": err}
            if kind != "threefry":
                assert bitwise, f"tree {key}: not bitwise {err}"
            else:
                assert err <= 1e-6, f"tree {key}: {err}"
            max_err = max(max_err, err)
    return res, max_err


def clip_library_fn(g, coef, acc=None):
    """The clip kernels' yardstick, as a function of no arguments: one
    PyTorch call computing the same function on the same inputs (another
    summation order), ``coef @ g``, or ``acc.addmv_(g.T, coef)`` for the
    in-place form.  cuBLAS's gemv raises past GEMV_MAX_ROWS columns; past
    them a single row takes the elementwise ``g[0] * coef`` or
    ``acc.addcmul_(g[0], coef)``, which move the bytes the bound counts,
    and more rows take none (None; no model here reaches that: the one
    buffer past 2^31 runs a physical batch of 1)."""
    m, d = g.shape
    if d <= GEMV_MAX_ROWS:
        return ((lambda: coef @ g) if acc is None
                else (lambda: acc.addmv_(g.T, coef)))
    if m == 1:
        return ((lambda: g[0] * coef) if acc is None
                else (lambda: acc.addcmul_(g[0], coef)))
    return None


def clip_inputs(gen, m, device):
    """norms and mask of m examples for the clip kernels' checks: about a
    quarter masked out (never row 0), a zero norm in row 0 where there
    are several rows, and a lone row clipped to half."""
    import torch
    norms = torch.rand(m, generator=gen, device=device) * 9.0
    norms[0] = 0.0 if m > 1 else 9.26
    mask = (torch.rand(m, generator=gen, device=device) > 0.25).float()
    mask[0] = 1.0
    return norms, mask


def check_clip_accum(view, device, tile, timer, spans=None):
    """clip_accum_inplace at the full flat length, m in {1, tile}, f32 and
    bf16 grads, bitwise against its plain version on ``spans`` ((start,
    end) of the flat buffer; all of it by default): the kernel folds into
    the accumulator in place, the plain version into copies of the spans
    taken just before."""
    import torch
    from repro_torch.kernels import clip_accum as ca

    gen = torch.Generator(device=device).manual_seed(2)
    d = view.total
    spans = [(0, d)] if spans is None else spans
    checks = {"windows": spans}
    max_err = 0.0
    timing = None
    for m in sorted({1, tile}):
        norms, mask = clip_inputs(gen, m, device)
        acc = torch.randn(d, generator=gen, device=device)
        for dt in (torch.float32, torch.bfloat16):
            g = torch.randn(m, d, generator=gen, device=device).to(dt)
            held = [acc[a:b].clone() for a, b in spans]
            ca.clip_accum_inplace(acc, g, norms, mask, 4.63)
            err, bitwise = 0.0, True
            for (a, b), want in zip(spans, held):
                ca.clip_accum_inplace_plain(want, g[:, a:b], norms, mask,
                                            4.63)
                err = max(err, float((acc[a:b] - want).abs().max()))
                bitwise = bitwise and same_bits(acc[a:b], want)
            del held
            key = f"m{m}_{str(dt).split('.')[-1]}"
            checks[key] = {"bitwise": bitwise, "max_abs_err": err}
            assert bitwise, f"clip_accum_inplace {key}: {err}"
            max_err = max(max_err, err)
            if m == tile and dt == torch.float32:
                coef = ca.clip_coefs(norms, mask, 4.63)
                library = clip_library_fn(g, coef, acc)  # or None
                bms, by = bound_ms((4.0 * m + 8.0) * d, 2.0 * m * d)
                timing = {
                    "ms": timer(lambda: ca.clip_accum_inplace(
                        acc, g, norms, mask, 4.63), 10),
                    "plain_ms": timer(lambda: ca.clip_accum_inplace_plain(
                        acc, g, norms, mask, 4.63), 3),
                    "bound_ms": bms, "bound_by": by,
                    "library_ms": library and timer(library, 10)}
            del g
        del acc
    return checks, max_err, timing


def device_kernels(fn):
    """The device kernels one call of ``fn`` runs, as ``{"name", "us"}``
    (the kernel's device time) from ``torch.profiler``; None off the card
    or where the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        return None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [{"name": e.name, "us": e.time_range.elapsed_us()}
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return kernels or None


# SASS opcodes counted per kernel: the Threefry rotations as funnel shifts,
# uniform-datapath integer work, and the tensor-core instructions
SASS_OPS = ("SHF", "UIADD3", "ULOP3", "LDSM", "HMMA", "LDGSTS")


def kernel_resources(libs):
    """Per kernel of each built library: registers, stack, shared and local
    bytes (``cuobjdump -res-usage``) and counts of SASS_OPS (``cuobjdump
    -sass``).  Informational: None where the toolkit has no cuobjdump."""
    import re
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    out = {}
    for name, lib in libs.items():
        res = subprocess.run([str(tool), "-res-usage", str(lib)],
                             capture_output=True, text=True, timeout=120,
                             check=True).stdout
        fn = None
        for line in res.splitlines():
            m = re.search(r"Function (\S+):", line)
            if m:
                fn = m.group(1)
                continue
            m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)",
                          line)
            if m and fn:
                out[fn] = dict(zip(("reg", "stack", "shared", "local"),
                                   map(int, m.groups())))
        sass = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                out.setdefault(fn, {}).update({op: 0 for op in SASS_OPS})
                continue
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                          line)
            if m and fn and m.group(1) in SASS_OPS:
                out[fn][m.group(1)] += 1
    return out


def check_ghost_norm(device, timer, shapes=None):
    """ghost_norm_dense against its plain version at ViT-Base's dense
    shapes, a ragged shape and the DenseLM direct-path shape, bf16 as the
    tape records them (and f32 at GHOST_NORM_F32's), reruns bit-identical,
    one launch per call; times per shape beside the bound, the plain
    version and the library yardstick."""
    import torch
    from repro_torch.kernels import ghost_norm as gn

    gen = torch.Generator(device=device).manual_seed(3)
    res, max_err = {}, 0.0
    shapes = GHOST_NORM_SHAPES if shapes is None else shapes
    for label, (B, T, di, do) in shapes.items():
        for dt in (torch.bfloat16, torch.float32):
            if dt == torch.float32 and label not in GHOST_NORM_F32:
                continue
            x = torch.randn(B, T, di, generator=gen, device=device).to(dt)
            dy = torch.randn(B, T, do, generator=gen, device=device).to(dt)
            k = gn.ghost_norm_dense(x, dy)
            p = gn.ghost_norm_dense_plain(x, dy)
            rel = float(((k - p).abs() / p.abs()).max())
            err = float((k - p).abs().max())
            before = gn.ghost_norm_dense.launches
            rerun = gn.ghost_norm_dense(x, dy)
            c = {"max_rel_err": rel, "max_abs_err": err,
                 "rerun_bitwise": same_bits(k, rerun),
                 "launches_per_call": gn.ghost_norm_dense.launches - before}
            # both against an f64 product of the same inputs: the largest
            # relative error and its signed mean (a bias shows there)
            m = torch.einsum("bti,bto->bio", x.double(), dy.double())
            ref = (m * m).sum(dim=(1, 2))
            del m
            for side, v in (("kernel", k), ("plain", p)):
                d = (v.double() - ref) / ref
                c[f"{side}_vs_f64_max_rel"] = float(d.abs().max())
                c[f"{side}_vs_f64_mean_rel"] = float(d.mean())
            key = f"{label}_{str(dt).split('.')[-1]}"
            assert rel <= GHOST_NORM_REL_TOL, (key, c)
            assert c["rerun_bitwise"], (key, c)
            if device.type == "cuda":
                assert c["launches_per_call"] == 1, (key, c)
                # what the card ran for one call (the scratch is warm)
                c["device_kernels"] = device_kernels(
                    lambda: gn.ghost_norm_dense(x, dy))
                assert c["device_kernels"] is None or len(
                    c["device_kernels"]) == 1, (key, c)
            max_err = max(max_err, err)
            xf, df = x.float(), dy.float()
            # bf16 operands: the product's multiply-adds at the bf16 rate,
            # the f32 square-and-add of each product entry at f32's; f32
            # operands: all at f32's (the CUDA cores, no TF32)
            mults = 2.0 * B * di * do * T
            bms, by = bound_ms(
                x.element_size() * (x.numel() + dy.numel()) + 4.0 * B,
                f32_ops=2.0 * B * di * do + (
                    mults if dt == torch.float32 else 0.0),
                bf16_ops=mults if dt == torch.bfloat16 else 0.0)
            c.update({
                "shape": [B, T, di, do],
                "host_us_per_call": host_us(
                    lambda: gn.ghost_norm_dense(x, dy), 20),
                "ms": timer(lambda: gn.ghost_norm_dense(x, dy), 20),
                "plain_ms": timer(
                    lambda: gn.ghost_norm_dense_plain(x, dy), 5),
                "bound_ms": bms, "bound_by": by,
                # one batched product and its sum of squares on f32 copies
                # of the same inputs: the yardstick
                "library_ms": timer(lambda: torch.bmm(
                    xf.transpose(1, 2), df).square().sum(dim=(1, 2)), 20)})
            del xf, df
            res[key] = c
            del x, dy, k, p, rerun
    return res, max_err


def check_clip_accum_resident(view, device, batch, timer, spans=None):
    """The resident clip_accum at (batch, flat length), f32 and bf16,
    bitwise against its plain version on ``spans`` ((start, end) of the
    flat buffer; all of it by default); timed in f32 (the per-example
    grads' dtype on the main path)."""
    import torch
    from repro_torch.kernels import clip_accum as ca

    gen = torch.Generator(device=device).manual_seed(4)
    d, m = view.total, batch
    spans = [(0, d)] if spans is None else spans
    norms, mask = clip_inputs(gen, m, device)
    checks, max_err, timing = {"windows": spans}, 0.0, None
    for dt in (torch.float32, torch.bfloat16):
        g = torch.randn(m, d, generator=gen, device=device).to(dt)
        k = ca.clip_accum(g, norms, mask, 4.63)
        err, bitwise = 0.0, True
        for a, b in spans:
            p = ca.clip_accum_plain(g[:, a:b], norms, mask, 4.63)
            err = max(err, float((k[a:b] - p).abs().max()))
            bitwise = bitwise and same_bits(k[a:b], p)
            del p
        del k
        key = f"m{m}_{str(dt).split('.')[-1]}"
        checks[key] = {"bitwise": bitwise, "max_abs_err": err}
        assert bitwise, f"clip_accum {key}: {err}"
        max_err = max(max_err, err)
        if dt == torch.float32:
            coef = ca.clip_coefs(norms, mask, 4.63)
            library = clip_library_fn(g, coef)  # or None
            bms, by = bound_ms((4.0 * m + 4.0) * d, 2.0 * m * d)
            timing = {
                "ms": timer(lambda: ca.clip_accum(g, norms, mask, 4.63), 10),
                "plain_ms": timer(lambda: ca.clip_accum_plain(
                    g, norms, mask, 4.63), 3),
                "bound_ms": bms, "bound_by": by,
                "library_ms": library and timer(library, 10)}
        del g
    return checks, max_err, timing


# --------------------------------------------------------------------------
# phase 4: the main path
# --------------------------------------------------------------------------

# the kernels each engine's fit() must launch
ENGINE_KERNELS = {
    "masked_fused_stream": ("noisy_sgd_update", "clip_accum_inplace"),
    "masked_ghost": ("noisy_sgd_update", "ghost_norm_dense"),
    "masked_bk": ("noisy_sgd_update", "ghost_norm_dense"),
    "masked_fused": ("noisy_sgd_update", "clip_accum"),
    "masked_pe": ("noisy_sgd_update",),
    "nonprivate": ("noisy_sgd_update",),
}


def kernel_wrappers():
    """name -> the wrapper whose ``launches`` counts that kernel
    ("noise_only": the noise-only body of ``noisy_sgd_update``)."""
    from repro_torch.kernels import clip_accum as ca
    from repro_torch.kernels import ghost_norm as gn
    from repro_torch.kernels import noisy_update as nu
    return {"noisy_sgd_update": nu.noisy_sgd_update,
            "noise_only": nu.tree_noise,
            "clip_accum_inplace": ca.clip_accum_inplace,
            "ghost_norm_dense": gn.ghost_norm_dense,
            "clip_accum": ca.clip_accum}


def zero_counts():
    for w in kernel_wrappers().values():
        w.launches = 0


def read_counts() -> dict:
    return {name: w.launches for name, w in kernel_wrappers().items()}


def run_fit(arch, device, train_kw, engine="masked_fused_stream",
            direct_denses=0, optimizer=None, fit_kw=None, prepare=None):
    """fit() of ``arch`` (a name or an ArchConfig) with ``engine`` (and
    ``optimizer``, else the TrainConfig's; ``prepare``, a function of the
    session, runs before the fit);
    every kernel counter is set to 0 just before and read just after.  The
    update launches ``noisy_sgd_update`` once per step when the optimizer
    is fused, else its noise-only body once per step and the fused form
    never.  ``direct_denses`` is the number of dense layers the Mixed-Ghost
    rule sends to the kernel in one norm pass: a record engine must launch
    ``ghost_norm_dense`` exactly that many times per physical batch (one
    norm pass each), the other engines never.  ``nonprivate`` spends no ε
    and its update is the kernel's noise-free form.  Returns (session,
    record, launches)."""
    import torch
    from repro_torch.core import DPConfig, fused_sgd
    from repro_torch.core.session import PrivacySession, TrainConfig
    from repro_torch.privacy import epsilon_for

    tc = TrainConfig(**train_kw)
    session = PrivacySession.from_config(
        arch, DPConfig(engine=engine, clip_norm=4.63), tc, device=device,
        optimizer=optimizer)
    if prepare is not None:
        prepare(session)
    if not isinstance(arch, str):
        arch = f"{arch.name} ({arch.n_layers} layers)"
    fused = fused_sgd(session.optimizer)
    update_kernel, idle = (("noisy_sgd_update", "noise_only") if fused
                           else ("noise_only", "noisy_sgd_update"))
    cuda = device.type == "cuda"
    if cuda:
        # what the session and anything left by earlier work hold
        allocated_before = torch.cuda.memory_allocated(device)
        log(f"{arch} fit {engine}: {allocated_before / 1e9:.2f} GB "
            f"allocated before it")
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize()
        retries = alloc_retries(device)
    # one accumulate per physical batch: one norm pass of a record engine
    accumulate, passes = session._accumulate, []

    def counted(*args):
        passes.append(1)
        return accumulate(*args)

    session._accumulate = counted
    zero_counts()
    t0 = time.perf_counter()
    out = session.fit(**(fit_kw or {}))
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    # a wrapper counts where it launches its kernel: on the card only
    needed = [k for k in ENGINE_KERNELS[engine] if k != "noisy_sgd_update"
              and (k != "ghost_norm_dense" or direct_denses)]
    for name in [*needed, update_kernel] if cuda else ():
        assert launches[name] > 0, f"fit() with {engine} launched {name} " \
                                   f"no time"
    session._accumulate = accumulate
    record_based = session.describe()["engine_traits"]["record_based"]
    ghost_launches = direct_denses * len(passes) if record_based else 0
    if cuda:
        # the update is one launch per step over every leaf
        assert launches[update_kernel] == tc.steps, (engine, launches)
        assert launches[idle] == 0, (engine, launches)
        assert launches["ghost_norm_dense"] == ghost_launches, (
            engine, launches, len(passes), direct_denses)
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == tc.steps and all(map(math.isfinite, losses)), out
    assert all(bool(torch.isfinite(p).all())
               for p in session.state.params.values()), "non-finite params"
    if session.dp.private:
        eps = epsilon_for(tc.sampler, session.describe()["q"],
                          session.dp.noise_multiplier, tc.steps,
                          tc.resolved_delta)
        assert out["final_eps"] == eps, (out["final_eps"], eps)
        assert eps <= tc.target_eps, eps
    else:
        assert out["final_eps"] == 0.0, out["final_eps"]
    record = {"engine": engine, "optimizer": session.optimizer.kind,
              "nesterov": bool(session.optimizer.hyper.get("nesterov")),
              "steps": tc.steps,
              "history": out["history"], "sigma": out["sigma"],
              "final_eps": out["final_eps"], "fit_seconds": seconds,
              "examples": sum(h["logical_batch"] for h in out["history"]),
              "examples_per_s": out["examples_per_s"],
              "stream_tile": session.describe()["stream_tile"],
              "engine_traits": session.describe()["engine_traits"],
              "physical_batches": len(passes),
              "launches": launches,
              **({"allocated_before_bytes": allocated_before,
                  **memory_record(device, retries)} if cuda
                 else {"peak_mem_bytes": None})}
    return session, record, launches


def alloc_retries(dev) -> int:
    """The caching allocator's count of cudaMalloc calls it retried after
    freeing its cache: each one synchronises the card and marks a run
    that came near the memory's end."""
    import torch
    return torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)


def memory_record(dev, retries_before: int) -> dict:
    """Peak allocated and reserved bytes since the last reset, the card's
    total, what the peak leaves of it, and the allocator's retries since
    ``retries_before``."""
    import torch
    total = torch.cuda.get_device_properties(dev).total_memory
    peak = torch.cuda.max_memory_allocated(dev)
    return {"peak_mem_bytes": peak,
            "peak_reserved_bytes": torch.cuda.max_memory_reserved(dev),
            "total_mem_bytes": total, "headroom_bytes": total - peak,
            "alloc_retries": alloc_retries(dev) - retries_before}


def _peak_since(dev, fn):
    """Run ``fn``; return (its result, the peak bytes it allocated over what
    was allocated when it started, the peak bytes the caching allocator
    reserved)."""
    import torch
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    return (out, torch.cuda.max_memory_allocated(dev) - base,
            torch.cuda.max_memory_reserved(dev))


def tilewise_fold(loss_fn, params, batch, mask, m, view, clip_norm):
    """The streaming engine's sum built the plain way from the same
    per-example grads it sees: the batch padded by example 0 with mask 0,
    vmap(grad) over each tile of m, every row flattened on its own, and one
    strict left fold over all rows from +0."""
    import torch
    from repro_torch.core.clipping import clip_coef, per_example_grads_and_sq
    B = int(mask.shape[0])
    pad = (-B) % m
    if pad:
        batch = {k: torch.cat([v] + [v[:1]] * pad) for k, v in batch.items()}
        mask = torch.cat([mask, mask.new_zeros(pad)])
    out = view.zeros(mask.device)
    for start in range(0, B + pad, m):
        sl = slice(start, start + m)
        grads, sq = per_example_grads_and_sq(
            loss_fn, params, {k: v[sl] for k, v in batch.items()})
        coef, _ = clip_coef(sq, mask[sl], clip_norm)
        for b in range(m):
            out = out + view.flatten({k: v[b] for k, v in grads.items()}) \
                * coef[b]
        del grads
    return out


def compare_engines(session, tile):
    """masked_pe against masked_fused_stream on one fixed physical batch at
    tiles {STREAM_SMALL_TILE, tile, B}, each streaming call's peak memory
    against the sizing rule's bytes for its tile, one streaming call with
    the tile left to the rule at a batch where the rule binds, and the
    per-example gradient bits of one row at vmap widths 1, 2, 4."""
    import numpy as np
    import torch
    from repro_torch.core.clipping import (per_example_grads_and_sq,
                                           resolve_engine)
    from repro_torch.data.synthetic import dataset_for_config
    from repro_torch.launch.costmodel import (STREAM_FIXED_F32_BUFFERS,
                                              STREAM_PE_SLABS,
                                              free_memory_bytes,
                                              stream_tile_size)
    from repro_torch.utils.params import FlatGradView

    tc, dev = session.train_cfg, session.device
    ds = dataset_for_config(session.model_cfg, tc.n_data, tc.seq_len,
                            seed=tc.seed)
    B = tc.physical_batch
    batch, mask = session._place(ds.fetch(np.arange(B)),
                                 (np.arange(B) < B - B // 4)
                                 .astype(np.float32))
    params, loss_fn = session.state.params, session.loss_fn
    view = FlatGradView.for_params(params)
    stream = resolve_engine("masked_fused_stream")
    slab = 4.0 * view.n_params

    def modelled_bytes(m):
        return (STREAM_PE_SLABS * m + STREAM_FIXED_F32_BUFFERS) * slab

    summed, _ = resolve_engine("masked_pe")(loss_fn, params, batch, mask,
                                            4.63)
    acc_pe = view.flatten(summed)
    del summed
    res = {}
    for m in sorted({STREAM_SMALL_TILE, tile, B}):
        acc_s = view.zeros(dev)
        _, peak, reserved = _peak_since(dev, lambda: stream(
            loss_fn, params, batch, mask, 4.63, acc=acc_s, view=view,
            tile=m))
        err = float((acc_s - acc_pe).abs().max())
        scale = float(acc_pe.abs().max())
        fold = tilewise_fold(loss_fn, params, batch, mask, m, view, 4.63)
        res[f"tile{m}"] = {"bitwise": same_bits(acc_s, acc_pe),
                           "max_abs_err": err, "max_abs_acc": scale,
                           "rel_l2_err": float((acc_s - acc_pe).norm()
                                               / acc_pe.norm()),
                           "tilewise_fold_bitwise": same_bits(acc_s, fold),
                           "peak_bytes": peak,
                           "peak_slabs_per_example": peak / slab / m,
                           "peak_reserved_bytes": reserved,
                           "modelled_bytes": modelled_bytes(m)}
        del fold
        log(f"stream tile {m} vs masked_pe: {json.dumps(res[f'tile{m}'])}")
        assert res[f"tile{m}"]["tilewise_fold_bitwise"], (m, res)
        assert err <= STREAM_PE_REL_TOL * scale, (m, err, scale)
        assert peak <= modelled_bytes(m), (m, peak, modelled_bytes(m))
        if m == B:
            # the same vmap width on the same batch: the same bits
            assert res[f"tile{m}"]["bitwise"], res
        del acc_s
    lo, hi = min(STREAM_SMALL_TILE, B), max(STREAM_SMALL_TILE, B)
    res["peak_bytes_per_example"] = (res[f"tile{hi}"]["peak_bytes"]
                                     - res[f"tile{lo}"]["peak_bytes"]) / (
        hi - lo)
    res["slab_bytes"] = slab
    del acc_pe
    rows = {}
    for w in (1, 2, 4):
        g, _ = per_example_grads_and_sq(
            loss_fn, params, {k: v[:w] for k, v in batch.items()})
        rows[w] = view.flatten({k: v[0] for k, v in g.items()})
        del g
    res["row0_bits_width1_eq_width2"] = same_bits(rows[1], rows[2])
    res["row0_bits_width2_eq_width4"] = same_bits(rows[2], rows[4])
    # how far the widths move one row, as a share of its largest entry
    top = float(rows[4].abs().max())
    res["row0_width1_vs_4_max_rel"] = float(
        (rows[1] - rows[4]).abs().max()) / top
    res["row0_width2_vs_4_max_rel"] = float(
        (rows[2] - rows[4]).abs().max()) / top
    del rows, batch, mask
    torch.cuda.empty_cache()
    # the rule binding: a batch of twice the tile the rule gives for the
    # memory free now; the engine sizes its own tile and must not run out
    free = free_memory_bytes(dev)
    m_rule = stream_tile_size(10 ** 6, view.n_params, free)
    n_big = 2 * m_rule
    big, big_mask = session._place(ds.fetch(np.arange(n_big) % tc.n_data),
                                   np.ones(n_big, np.float32))
    acc_s = view.zeros(dev)
    free = free_memory_bytes(dev)
    t0 = time.perf_counter()
    (_, aux), peak, reserved = _peak_since(dev, lambda: stream(
        loss_fn, params, big, big_mask, 4.63, acc=acc_s, view=view))
    assert bool(torch.isfinite(acc_s).all()) and bool(
        torch.isfinite(aux["per_example_norms"]).all())
    res["rule_binds"] = {"batch": n_big, "free_bytes": free,
                         "tile": stream_tile_size(n_big, view.n_params, free),
                         "peak_bytes": peak, "peak_reserved_bytes": reserved,
                         "seconds": time.perf_counter() - t0}
    log(f"stream with the rule's tile: {json.dumps(res['rule_binds'])}")
    assert res["rule_binds"]["tile"] < n_big, res["rule_binds"]
    assert peak <= free, res["rule_binds"]
    return res


def _fixed_batch(session):
    """The first physical batch of the dataset, its last quarter masked."""
    import numpy as np
    from repro_torch.data.synthetic import dataset_for_config
    tc = session.train_cfg
    ds = dataset_for_config(session.model_cfg, tc.n_data, tc.seq_len,
                            seed=tc.seed)
    B = tc.physical_batch
    return session._place(ds.fetch(np.arange(B)),
                          (np.arange(B) < B - B // 4).astype(np.float32))


def routing_agreement(session, batch):
    """The experts each MoE layer selects, and which assignments it keeps
    at capacity, in the batched forward (the record engines' and
    ``nonprivate``'s) against one forward per example under ``vmap`` (the
    per-example engines'): the count of differing entries per layer."""
    from repro_torch.models.moe import routing
    params, loss_fn = session.state.params, session.loss_fn
    batched = routing(loss_fn, params, batch)
    per = routing(loss_fn, params, batch, per_example=True)
    layers = [{"assignments": e1.numel(),
               "dropped": int((~v1).sum()),
               "experts_differ": int((e1 != e2).sum()),
               "kept_differ": int((v1 != v2).sum())}
              for (e1, v1), (e2, v2) in zip(batched, per)]
    return {"layers": layers,
            "agree": all(r["experts_differ"] == r["kept_differ"] == 0
                         for r in layers)}


def compare_record_engines(session, limits, stream_pe=False):
    """On one fixed physical batch: masked_fused (bitwise), masked_ghost,
    masked_bk and the streaming engine's "ghost" norm source against
    masked_pe, and every dense layer's ghost norm through the kernel
    (forced direct path) against the einsum (forced ghost path), held to
    ``limits`` (the model's named limits: "pe", "leaf" per engine, "norms",
    "forced").  With ``stream_pe`` the streaming engine with its own norms
    at tile = batch is held bitwise too.  On an MoE model the routing of
    the engines' two kinds of forward is compared first and any difference
    is printed (a flipped expert is a finding, not a reason for a wider
    limit)."""
    import torch
    from repro_torch.core import fused, layers
    from repro_torch.core.clipping import _eps_backward, resolve_engine
    from repro_torch.utils.params import FlatGradView

    batch, mask = _fixed_batch(session)
    params, loss_fn = session.state.params, session.loss_fn
    view = FlatGradView.for_params(params)
    run = {e: resolve_engine(e) for e in ("masked_pe", "masked_fused",
                                          "masked_ghost", "masked_bk")}
    routing = {}
    if session.model_cfg.family == "moe":
        routing["routing"] = routing_agreement(session, batch)
        log(f"routing, batched vs per-example forward: "
            f"{json.dumps(routing['routing'])}")
    # two host buffers, masked_pe's sum and each engine's in turn
    acc_pe, acc_host = host_buffer(view.total), host_buffer(view.total)

    def host_flat(summed, out):
        """The summed grads flattened into the host buffer ``out``, their
        device copies released: at DenseLM's width the engines need the
        card's room."""
        out.copy_(view.flatten(summed))
        summed.clear()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return out

    summed, pe_aux = run["masked_pe"](loss_fn, params, batch, mask, 4.63)
    host_flat(summed, acc_pe)
    dev = session.device
    # the statistics are taken on the card, after each engine's memory is
    # released (on the host they took a minute a model at SSM width)
    p = acc_pe.to(dev)
    scale = float(p.abs().max())
    pe_leaf_max = [float(p[o:o + n].abs().max())
                   for o, n in zip(view.offsets, view.sizes)]
    pe_l2 = float(p.norm())
    del p
    pe_norms = pe_aux["per_example_norms"].cpu()
    res = {"max_abs_acc": scale, **routing}

    def against_pe(acc, norms):
        norms = norms.cpu()
        # a copy of acc, taken in place into |acc - pe| once compared: two
        # flat buffers on the card besides the session's (at the VLM's
        # 3.82G a third would not fit)
        a, p = acc.to(dev, copy=True), acc_pe.to(dev)
        bitwise = same_bits(a, p)
        d = a.sub_(p).abs_()
        del a, p
        leaf = {nm: float(d[o:o + n].max()) / max(top, LEAF_FLOOR * scale)
                for nm, o, n, top in zip(view.names, view.offsets,
                                         view.sizes, pe_leaf_max)}
        worst = max(leaf, key=leaf.get)
        err = float(d.max())
        out = {"bitwise": bitwise, "max_abs_err": err,
               "rel_to_max_acc": err / scale,
               "rel_l2_err": float(d.norm()) / pe_l2,
               "worst_leaf": worst, "worst_leaf_rel_err": leaf[worst],
               "norms_max_rel_err": float(((norms - pe_norms).abs()
                                           / pe_norms).max())}
        del d
        return out

    def hold(key, r):
        assert r["rel_to_max_acc"] <= limits["pe"][key], (key, r)
        assert r["worst_leaf_rel_err"] <= limits["leaf"][key], (key, r)
        assert r["norms_max_rel_err"] <= limits["norms"], (key, r)

    ghost_norms = None
    for e in ("masked_fused", "masked_ghost", "masked_bk"):
        kw = {"check_coverage": True} if e == "masked_bk" else {}
        summed, aux = run[e](loss_fn, params, batch, mask, 4.63, **kw)
        acc = host_flat(summed, acc_host)
        res[e] = against_pe(acc, aux["per_example_norms"])
        if e == "masked_ghost":
            ghost_norms = aux["per_example_norms"]
        log(f"{e} vs masked_pe: {json.dumps(res[e])}")
        if e == "masked_fused":
            assert res[e]["bitwise"], res[e]
        else:
            hold(e, res[e])
        del acc
    if stream_pe:
        # the streaming engine's own norms at tile = batch: masked_pe's
        # grads at masked_pe's width, folded in its order
        acc = session.state.grad_acc.zero_()
        _, aux = resolve_engine("masked_fused_stream")(
            loss_fn, params, batch, mask, 4.63, acc=acc, view=view,
            tile=int(mask.shape[0]))
        r = res["masked_fused_stream"] = against_pe(acc,
                                                    aux["per_example_norms"])
        log(f"masked_fused_stream (tile = batch) vs masked_pe: "
            f"{json.dumps(r)}")
        assert r["bitwise"], r
    # the streaming engine with the "ghost" norm source, tile = batch
    prev = fused.set_stream_norm_source("ghost")
    try:
        # the session's own accumulator: no room for a second at DenseLM's
        # width
        acc = session.state.grad_acc.zero_()
        _, aux = resolve_engine("masked_fused_stream")(
            loss_fn, params, batch, mask, 4.63, acc=acc, view=view,
            tile=int(mask.shape[0]))
    finally:
        fused.set_stream_norm_source(prev)
    r = against_pe(acc, aux["per_example_norms"])
    r["norms_bitwise_vs_masked_ghost"] = same_bits(aux["per_example_norms"],
                                                   ghost_norms)
    res["masked_fused_stream_ghost"] = r
    log(f"masked_fused_stream (ghost norms) vs masked_pe: {json.dumps(r)}")
    hold("masked_fused_stream_ghost", r)
    assert r["norms_bitwise_vs_masked_ghost"], r
    del acc, acc_pe, acc_host
    # every dense layer: the kernel (direct) against the einsum (ghost)
    dEps, records, specs, _ = _eps_backward(loss_fn, params, batch)
    per_layer = {}
    prev = layers._FORCE_PATH
    try:
        for name, spec in specs.items():
            if spec.kind != "dense":
                continue
            out = {}
            for path in ("direct", "ghost"):
                layers._FORCE_PATH = path
                out[path] = layers.per_example_sq_norm(
                    spec, layers.resolve_record(records, name, spec),
                    dEps[name])
            per_layer[name] = float(((out["direct"] - out["ghost"]).abs()
                                     / out["ghost"].abs()).max())
    finally:
        layers._FORCE_PATH = prev
    res["forced_direct_vs_ghost_max_rel"] = per_layer
    log(f"ghost norms, kernel vs einsum, per dense layer: "
        f"{json.dumps(per_layer)}")
    assert max(per_layer.values()) <= limits["forced"], per_layer
    del dEps, records
    return res


ACCUMULATE_ENGINES = ("nonprivate", "masked_pe", "masked_fused",
                      "masked_fused_stream", "masked_ghost", "masked_bk")


def time_accumulate(session, iters=3):
    """One accumulate of the fixed physical batch per engine (host clock
    around synchronised calls, after one warm-up call), and its peak
    memory; the ratio to nonprivate is the paper's DP overhead.  The
    accumulates add into the session's own accumulator, zeroed before each
    call: at DenseLM's width the card has no room for a second one.  The
    warm-up call masks every example out and must leave the accumulator
    exactly 0: a masked-out example's gradient, and its norm, reach no sum
    (at the SSM models' batch of 1 the fixed batch masks none).  The first
    and last timed calls' accumulators must be bit-identical (what a
    bitwise resume needs): the first is kept in a page-locked host buffer
    and compared with the last piece by piece on the card."""
    import torch
    from repro_torch.core.engine import DPConfig, build_accumulate_fn

    batch, mask = _fixed_batch(session)
    dev = session.device
    B = int(mask.shape[0])
    state = session.state
    first = host_buffer(state.grad_acc.numel())
    res = {}
    for e in ACCUMULATE_ENGINES:
        acc_fn = build_accumulate_fn(session.loss_fn, DPConfig(
            engine=e, clip_norm=4.63,
            stream_tile=B if e == "masked_fused_stream" else None))
        state.grad_acc.zero_()
        acc_fn(state, batch, torch.zeros_like(mask))
        nonzero = int(torch.count_nonzero(state.grad_acc))
        assert nonzero == 0, (e, "masked-out examples added", nonzero)
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            retries = alloc_retries(dev)
        times = []
        for i in range(iters):
            state.grad_acc.zero_()
            if cuda:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            acc_fn(state, batch, mask)
            if cuda:
                torch.cuda.synchronize(dev)
            times.append(1e3 * (time.perf_counter() - t0))
            if i == 0:
                first.copy_(state.grad_acc)
        res[e] = {"ms": sum(times) / iters, "min_ms": min(times),
                  "all_ms": times, "masked_out_acc_nonzero": nonzero,
                  **(memory_record(dev, retries) if cuda
                     else {"peak_mem_bytes": None})}
        res[e]["rerun_bitwise"] = same_bits_as_host(state.grad_acc, first)
        assert res[e]["rerun_bitwise"], (e, "reruns differ")
        del acc_fn
        if cuda:
            torch.cuda.empty_cache()
    base = res["nonprivate"]["ms"]
    for e in ACCUMULATE_ENGINES:
        res[e]["ratio_to_nonprivate"] = res[e]["ms"] / base
    return res


def run_cli(device, arch_args, engine="masked_pe"):
    """The training CLI's flow, in process, one step."""
    import math as _m
    from repro_torch.launch import train
    out = train.main([*arch_args, "--engine", engine, "--steps", "1",
                      "--device", str(device)])
    assert out["history"] and all(_m.isfinite(h["loss"])
                                  for h in out["history"]), out
    return {"history": out["history"], "final_eps": out["final_eps"]}


def norm_pass_cost(session):
    """One ghost-norm pass over the fixed physical batch, after its
    eps-backward: the ``ghost_norm_dense`` calls it makes, the host
    microseconds each call takes (the wrapper's own work and the launch, on
    the host clock around each call), the pass's synchronised wall time,
    and the kernel's device time in it as ``torch.profiler`` records it."""
    import torch
    from repro_torch.core import clipping, layers

    batch, _ = _fixed_batch(session)
    dev = session.device
    dEps, records, specs, losses = clipping._eps_backward(
        session.loss_fn, session.state.params, batch)
    B = losses.shape[0]

    def norm_pass():
        return clipping._sq_norms(dEps, records, specs, B, dev)

    norm_pass()                                    # warm
    inner, host = layers.ghost_norm_dense, []

    def timed(x, dy):
        t0 = time.perf_counter()
        out = inner(x, dy)
        host.append(time.perf_counter() - t0)
        return out

    layers.ghost_norm_dense = timed
    try:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        norm_pass()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        layers.ghost_norm_dense = inner
    res = {"ghost_norm_dense_calls": len(host),
           "host_us_per_call": 1e6 * sum(host) / max(len(host), 1),
           "host_us_all_calls": 1e6 * sum(host),
           "norm_pass_wall_ms": wall_ms}
    kernels = device_kernels(norm_pass)
    if kernels is not None:
        ours = [k["us"] for k in kernels if "ghost_norm" in k["name"]]
        total = sum(k["us"] for k in kernels)
        res.update({"kernel_device_us_all_calls": sum(ours),
                    "kernel_device_us_per_call": sum(ours) / max(len(ours),
                                                                 1),
                    "kernel_calls_profiled": len(ours),
                    "device_us_all_kernels": total,
                    "kernel_share_of_device_time": sum(ours) / max(total,
                                                                   1e-9),
                    "device_kernels_in_pass": len(kernels)})
    del dEps, records
    return res


def run_denselm(device, timer):
    """Phase 5: full-width qwen2-0.5b at 1,024 tokens.  Each kernel against
    its plain version at DenseLM's shapes, then fit() per engine (the
    counters set to 0 just before each run and read just after), the record
    engines against masked_pe under DENSELM_LIMITS, the host cost of one
    norm pass, one accumulate per engine against nonprivate, and the CLI."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import DPConfig
    from repro_torch.core.session import PrivacySession, TrainConfig
    from repro_torch.launch.costmodel import (free_memory_bytes,
                                              stream_tile_size)
    from repro_torch.models import build
    from repro_torch.utils.params import FlatGradView

    cfg = get_config(DENSELM_ARCH)
    model = build(cfg, device=device)
    view = FlatGradView.for_params(model.params())
    del model
    torch.cuda.empty_cache()
    assert view.n_params == DENSELM_PARAMS, view.n_params
    B = DENSELM_TRAIN["physical_batch"]
    tile = stream_tile_size(B, view.n_params, free_memory_bytes(device))
    res = {"arch": DENSELM_ARCH, "n_params": view.n_params,
           "flat": view.total, "seq_len": DENSELM_TRAIN["seq_len"],
           "stream_tile": tile}
    log(f"{DENSELM_ARCH}: {view.n_params} params, flat {view.total}, "
        f"stream tile {tile}")
    gn_checks, gn_err = check_ghost_norm(device, timer, DENSELM_GHOST_SHAPES)
    log(f"denselm ghost_norm_dense: {json.dumps(gn_checks)}")
    tree, tree_err = check_tree_noisy_update(view, device, (0x1234, 0xBEEF))
    nu_time, nu_checks = time_tree_update(view, device, timer)
    nu_checks["tree"] = tree
    log(f"denselm noisy_sgd_update: {json.dumps(nu_checks)} "
        f"{json.dumps(nu_time)}")
    torch.cuda.empty_cache()
    ca_checks, ca_err, ca_time = check_clip_accum(view, device, tile, timer)
    log(f"denselm clip_accum_inplace: {json.dumps(ca_checks)} "
        f"{json.dumps(ca_time)}")
    torch.cuda.empty_cache()
    cr_checks, cr_err, cr_time = check_clip_accum_resident(view, device, B,
                                                           timer)
    log(f"denselm clip_accum: {json.dumps(cr_checks)} {json.dumps(cr_time)}")
    torch.cuda.empty_cache()
    res["kernel_checks"] = {
        "ghost_norm_dense": {"checks": gn_checks, "max_abs_err": gn_err},
        "noisy_sgd_update": {"checks": nu_checks, "max_abs_err": tree_err,
                             **nu_time},
        "clip_accum_inplace": {"checks": ca_checks, "max_abs_err": ca_err,
                               **ca_time},
        "clip_accum": {"checks": cr_checks, "max_abs_err": cr_err,
                       **cr_time}}
    direct = DENSELM_DIRECT_PER_LAYER * cfg.n_layers
    res["direct_denses_per_norm_pass"] = direct
    res["fit"] = {}
    session = None
    for engine, steps in (("masked_bk", 2), ("masked_ghost", 2),
                          ("masked_fused_stream", 2), ("masked_fused", 1)):
        del session
        torch.cuda.empty_cache()
        session, rec, _ = run_fit(DENSELM_ARCH, device,
                                  dict(DENSELM_TRAIN, steps=steps), engine,
                                  direct_denses=direct)
        res["fit"][engine] = rec
        log(f"denselm fit {engine}: {json.dumps(rec)}")
    # the comparisons, the norm pass and the accumulate times on a session
    # without momentum: its buffer is room the per-example engines need
    del session
    torch.cuda.empty_cache()
    session = PrivacySession.from_config(
        DENSELM_ARCH, DPConfig(engine="masked_pe", clip_norm=4.63),
        TrainConfig(**dict(DENSELM_TRAIN, steps=1, momentum=0.0)),
        device=device)
    res["record_engines"] = compare_record_engines(session, DENSELM_LIMITS)
    torch.cuda.empty_cache()
    res["norm_pass"] = norm_pass_cost(session)
    log(f"denselm norm pass: {json.dumps(res['norm_pass'])}")
    assert res["norm_pass"]["ghost_norm_dense_calls"] == direct, res
    torch.cuda.empty_cache()
    res["accumulate"] = time_accumulate(session)
    log(f"denselm accumulate of one physical batch of {B} x "
        f"{DENSELM_TRAIN['seq_len']} tokens, ms and ratio to nonprivate: "
        f"{json.dumps(res['accumulate'])}")
    del session
    torch.cuda.empty_cache()
    res["cli"] = run_cli(device, [
        "--arch", DENSELM_ARCH, "--seq-len", str(DENSELM_TRAIN["seq_len"]),
        "--physical", str(B), "--n-data", str(DENSELM_TRAIN["n_data"])],
        "masked_fused_stream")
    log(f"denselm cli: {json.dumps(res['cli'])}")
    return res


# --------------------------------------------------------------------------
# phase 6: the training lifecycle on full-width ViT-Base
# --------------------------------------------------------------------------

# the fits of phase 4's configuration (n 512, q 0.125, physical batch 32)
LIFECYCLE_TRAIN = dict(n_data=512, q=0.125, physical_batch=32,
                       target_eps=8.0, smoke=False)
# masked_fused at microbatches=4 against microbatches=1 on one batch of 32,
# as a share of max |acc|: each microbatch takes its per-example grads at
# width 8 instead of 32, the width question of the streaming tile, so the
# streaming tile's bound
MICROBATCH_REL_TOL = STREAM_PE_REL_TOL
MICROBATCHES = 4
# the chaos cases: full-width ViT-Base, masked_fused_stream, 6 steps with a
# checkpoint every 2, the reference's arming for the checkpoint points (on
# the second save); the other four training points run on the CPU
# (tests/test_torch_chaos.py).  Each case must resume from a snapshot, not
# fall back to a fresh run.  fit/step_end is armed at step 5, not the
# reference's 3: a 0.69 GB commit takes about 2 s, longer than step 3, so
# a kill at step 3 finds no durable snapshot and the "resume" is a fresh
# run; by step 5 the save at step 4 has waited for step 2's commit
CHAOS_CASE = dict(arch="vit-base", full=True, engine="masked_fused_stream",
                  steps=6, ckpt_every=2, n_data=128, q=0.125,
                  physical_batch=16, seq_len=16, sigma=0.8, timeout=300)
CHAOS_POINTS = ("ckpt/mid_d2h", "ckpt/after_state_before_manifest",
                "fit/step_end")
CHAOS_AT = {"fit/step_end": 5}
# the protocol twin's arguments beyond --device (none: full width)
PROTOCOL_ARGS = ()
# bytes and operations per element of the noise-only body: 4 B written;
# Threefry's int32 operations; Box-Muller's f32 ones (log, sqrt and cos
# counted as one each, and its 5 products and sums)
NOISE_ONLY_F32_OPS = 8


def check_noise_only(view, device, timer, seed=(0x1234, 0xBEEF)):
    """The noise-only body of noisy_sgd_update (``tree_noise``) over every
    leaf of ``view`` against the plain ``threefry_normal`` per leaf, within
    NORMAL_ULP_BOUND, the alignment tail zero, one launch (and one device
    kernel) per call; its time beside its bound and the plain version's.
    No library call draws Threefry: ``library_ms`` is None."""
    import torch
    from repro_torch.kernels import noisy_update as nu

    gen = torch.Generator(device=device).manual_seed(6)
    params = {nm: torch.randn(view.shapes[i], generator=gen, device=device)
              for i, nm in enumerate(view.names)}
    z = torch.full((view.total,), float("nan"), device=device)
    before = nu.tree_noise.launches
    nu.tree_noise(params, seed, view=view, out=z)
    checks = {"launches_per_call": nu.tree_noise.launches - before}
    ulp, err = 0, 0.0
    for i in range(len(view.names)):
        o, n = view.offsets[i], view.sizes[i]
        zp = nu.threefry_normal(nu.leaf_seed(seed, i), n, device)
        ulp = max(ulp, max_ulp(z[o:o + n], zp))
        err = max(err, float((z[o:o + n] - zp).abs().max()))
        del zp
    checks.update(max_ulp=ulp, tail_zero=not bool(
        z[view.n_params:].any()))
    if device.type == "cuda":
        assert checks["launches_per_call"] == 1, checks
        checks["device_kernels_per_call"] = device_kernels(
            lambda: nu.tree_noise(params, seed, view=view, out=z))
        assert checks["device_kernels_per_call"] is None or len(
            checks["device_kernels_per_call"]) == 1, checks
    assert ulp <= NORMAL_ULP_BOUND and checks["tail_zero"], checks

    def plain():
        for i in range(len(view.names)):
            o, n = view.offsets[i], view.sizes[i]
            z[o:o + n] = nu.threefry_normal(nu.leaf_seed(seed, i), n, device)

    n_par = view.n_params
    table, rows, _ = nu.device_leaf_table(
        view, tuple(params[nm].data_ptr() for nm in view.names), device)
    bms, by = bound_ms(4.0 * n_par + table.numel() * 8,
                       NOISE_ONLY_F32_OPS * n_par, THREEFRY_I32_OPS * n_par)
    timing = {"ms": timer(lambda: nu.tree_noise(params, seed, view=view,
                                                out=z), 20),
              "plain_ms": timer(plain, 3), "bound_ms": bms, "bound_by": by,
              "library_ms": None, "max_abs_err": err}
    return checks, timing


def _clone_state(state):
    import dataclasses
    return dataclasses.replace(
        state, params={k: v.clone() for k, v in state.params.items()},
        opt_state={k: v.clone() if hasattr(v, "clone") else v
                   for k, v in state.opt_state.items()},
        grad_acc=state.grad_acc.clone(), seen=state.seen.clone())


def fused_vs_unfused(session):
    """One momentum-SGD update of the session's state through the fused
    kernel and through the generic path (noise-only body + the optimizer's
    rounded ops), from the same state and seeds: params and momentum
    bitwise; the generic path launches the noise-only body once and the
    fused form never."""
    import torch
    from repro_torch.core.engine import build_update_fn
    from repro_torch.utils.params import FlatGradView

    st = session.state
    view = FlatGradView.for_params(st.params)
    batch, mask = _fixed_batch(session)
    st.grad_acc.zero_()
    session._accumulate(st, batch, mask)
    a, b = _clone_state(st), _clone_state(st)
    st.grad_acc.zero_()
    st.seen.zero_()
    zero_counts()
    build_update_fn(session.optimizer, session.dp)(a)
    fused = read_counts()
    zero_counts()
    build_update_fn(session.optimizer, session.dp, fuse=False)(b)
    generic = read_counts()
    fa, fb = view.flatten(a.params), view.flatten(b.params)
    res = {"params_bitwise": same_bits(fa, fb),
           "momentum_bitwise": same_bits(a.opt_state["mom"],
                                         b.opt_state["mom"]),
           "max_abs_err": float((fa - fb).abs().max()),
           "moved": float((fa - view.flatten(st.params)).abs().max()),
           "fused_launches": fused, "generic_launches": generic}
    assert res["params_bitwise"] and res["momentum_bitwise"], res
    assert res["moved"] > 0, res
    if st.grad_acc.is_cuda:
        assert fused["noisy_sgd_update"] == 1 and fused["noise_only"] == 0
        assert generic["noise_only"] == 1 and \
            generic["noisy_sgd_update"] == 0, res
    del a, b, fa, fb
    if st.grad_acc.is_cuda:
        torch.cuda.empty_cache()
    return res


def compare_microbatches(session):
    """masked_fused with MICROBATCHES microbatches against one, on the
    fixed physical batch (the accumulator's share of max |acc|); clip_accum
    launches once per microbatch."""
    import dataclasses
    from repro_torch.core.engine import build_accumulate_fn

    batch, mask = _fixed_batch(session)
    st = session.state
    sums, launches = {}, {}
    for m in (1, MICROBATCHES):
        acc = build_accumulate_fn(session.loss_fn, dataclasses.replace(
            session.dp, engine="masked_fused", microbatches=m))
        st.grad_acc.zero_()
        zero_counts()
        acc(st, batch, mask)
        launches[m] = read_counts()["clip_accum"]
        sums[m] = st.grad_acc.to("cpu", copy=True)
    st.grad_acc.zero_()
    st.seen.zero_()
    top = float(sums[1].abs().max())
    rel = float((sums[MICROBATCHES] - sums[1]).abs().max()) / top
    res = {"microbatches": MICROBATCHES, "rel_err_of_max_acc": rel,
           "tol": MICROBATCH_REL_TOL, "clip_accum_launches": launches}
    assert rel <= MICROBATCH_REL_TOL, res
    if st.grad_acc.is_cuda:
        assert launches == {1: 1, MICROBATCHES: MICROBATCHES}, res
    return res


def _manifest_copy(src_dir, dst_dir, step):
    """A checkpoint directory holding only ``src_dir``'s snapshot of
    ``step`` (its manifest and state blob)."""
    import os
    import shutil
    os.makedirs(dst_dir, exist_ok=True)
    for name in sorted(os.listdir(src_dir)):
        if name.startswith("manifest-"):
            rec = json.loads((Path(src_dir) / name).read_text())
            if rec["step"] == step:
                for f in (name, rec["state"]):
                    shutil.copyfile(Path(src_dir) / f, Path(dst_dir) / f)
                return rec
    raise AssertionError(f"no snapshot of step {step} in {src_dir}")


def checkpoint_resume(device, work):
    """A 4-step masked_fused_stream fit with checkpoint_async every 2
    steps, then a fresh session that restores step 2 and runs 2 more:
    params sha256 and ε (``float.hex``) equal.  Records each save's size,
    its device->host copy and commit times, the fit's checkpoint waits and
    any step the writer delayed."""
    import warnings
    from repro_torch.core import DPConfig
    from repro_torch.core.session import PrivacySession, TrainConfig
    from repro_torch.obs import ObsConfig
    from repro_torch.resilience.chaos import outcome

    tc = TrainConfig(**dict(LIFECYCLE_TRAIN, steps=4))
    dp = DPConfig(engine="masked_fused_stream", clip_norm=4.63)
    ck, ck2 = str(work / "ck"), str(work / "ck-step2")
    s = PrivacySession.from_config("vit-base", dp, tc, device=device,
                                   obs=ObsConfig(mode="events"))
    zero_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        s.fit(ckpt=ck, ckpt_every=2)
    fit_s = time.perf_counter() - t0
    launches = read_counts()
    want = outcome(s)
    waits = s.obs.hists["fit/ckpt_wait"]
    res = {"fit_seconds": fit_s, "launches": launches,
           "stream_tile": s.describe()["stream_tile"],
           "saves": s._ckpt_writer.records,
           "ckpt_wait_s": list(waits._ring),
           "ckpt_wait_exceeded": s.obs.counters.get(
               "fit/ckpt_wait_exceeded", 0),
           "warnings": [str(w.message) for w in caught
                        if "checkpoint wait" in str(w.message)],
           "uninterrupted": want}
    del s
    _manifest_copy(ck, ck2, 2)
    r = PrivacySession.restore(ck2, "vit-base", dp, tc, device=device)
    zero_counts()
    r.fit(steps=2)
    for k, v in read_counts().items():
        launches[k] += v
    got = outcome(r)
    res.update(resumed=got, restored_tile=r.describe()["stream_tile"],
               match=(got["params_sha256"] == want["params_sha256"]
                      and got["eps_hex"] == want["eps_hex"]
                      and got["step"] == want["step"] == 4))
    assert res["match"], res
    assert [rec["step"] for rec in res["saves"]] == [2, 4], res
    del r
    return res


def run_chaos(work, device):
    """run_case in subprocesses on ``device`` for CHAOS_POINTS, one shared
    baseline: each resumed run bitwise equal to the uninterrupted one."""
    import dataclasses
    from repro_torch.resilience import chaos
    out, baseline = {}, None
    for point in CHAOS_POINTS:
        spec = chaos.DEFAULT_ARMING[point]
        if point in CHAOS_AT:
            spec = dataclasses.replace(spec, at=CHAOS_AT[point])
        t0 = time.perf_counter()
        rec = chaos.run_case(point, workdir=str(work), spec=spec,
                             device=device.type, baseline_out=baseline,
                             **CHAOS_CASE)
        rec["seconds"] = time.perf_counter() - t0
        baseline = str(work / "baseline.json")
        out[point] = {k: rec.get(k) for k in (
            "spec", "match", "fired", "crash_returncode", "seconds",
            "detail", "resumed", "baseline")}
        log(f"chaos {point}: {json.dumps(out[point])}")
        assert rec["fired"] and rec["match"], rec
        assert rec["resumed"]["resumed_from"] is not None, rec
    return out


def run_protocol_twin(device, extra_args=()):
    """The paper-protocol twin at full width through its module's main();
    kernel counters set to 0 just before and read just after."""
    from repro_torch.examples import paper_protocol_vit
    zero_counts()
    t0 = time.perf_counter()
    res = paper_protocol_vit.main(["--device", device.type, *extra_args])
    seconds = time.perf_counter() - t0
    launches = read_counts()
    for eng, r in res.items():
        assert math.isfinite(r["final_loss"]) and r["throughput_ex_s"] > 0, r
        if eng != "nonprivate":
            assert r["eps"] <= 8.0 + 1e-3, r
    # four engines (nonprivate's update is the noise-free form) x 4 steps
    if device.type == "cuda":
        assert launches["noisy_sgd_update"] == 4 * 4, launches
        assert launches["ghost_norm_dense"] > 0, launches
    return {"engines": res, "seconds": seconds, "launches": launches}


def run_lifecycle(device, timer, view):
    """Phase 6 (see the module docstring)."""
    import shutil

    import torch
    from repro_torch.optim import sgd

    res = {}
    work = ROOT / "build" / "chip_smoke_lifecycle"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t_phase = time.perf_counter()
    try:
        res["noise_only"] = check_noise_only(view, device, timer)
        log(f"noise_only: {json.dumps(res['noise_only'])}")
        torch.cuda.empty_cache()
        session, rec, launches = run_fit(
            "vit-base", device, dict(LIFECYCLE_TRAIN, steps=1),
            "masked_fused_stream", direct_denses=1)
        res["fused_vs_unfused"] = fused_vs_unfused(session)
        log(f"fused vs fuse=False: {json.dumps(res['fused_vs_unfused'])}")
        res["microbatches"] = compare_microbatches(session)
        log(f"microbatches: {json.dumps(res['microbatches'])}")
        fits = {"sgd_fit_for_the_comparisons": rec}
        del session
        for label in ("adamw", "nesterov"):
            torch.cuda.empty_cache()
            train = dict(LIFECYCLE_TRAIN, steps=2,
                         **({"optimizer": "adamw", "lr": 1e-4}
                            if label == "adamw" else {}))
            optimizer = (sgd(1e-3, momentum=0.9, nesterov=True)
                         if label == "nesterov" else None)
            session, rec, _ = run_fit("vit-base", device, train,
                                      "masked_fused_stream",
                                      direct_denses=1, optimizer=optimizer)
            if device.type == "cuda":
                assert rec["launches"]["noise_only"] == 2, rec
            fits[label] = rec
            log(f"fit {label}: {json.dumps(rec)}")
            del session
        res["fits"] = fits
        torch.cuda.empty_cache()
        res["checkpoint"] = checkpoint_resume(device, work)
        log(f"checkpoint + resume: {json.dumps(res['checkpoint'])}")
        torch.cuda.empty_cache()
        res["chaos"] = run_chaos(work / "chaos", device)
        torch.cuda.empty_cache()
        res["protocol"] = run_protocol_twin(device, PROTOCOL_ARGS)
        log(f"protocol twin: {json.dumps(res['protocol'])}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    return res


# --------------------------------------------------------------------------
# phase 7: the SSM and hybrid families
# --------------------------------------------------------------------------

# full-width mamba2-1.3b and zamba2-1.2b (the reference's configs: every
# width, the state, the heads, the chunk, zamba2's attn_every of 6), bf16
# activations, f32 params, random weights from the seed, at 1,024 tokens (a
# multiple of the SSD chunk of 64); n 64, q 0.125, eps 8, clip 4.63.  The
# physical batch is the largest of 4, 2 and 1 at which masked_fused fits:
# 1 for both (at 2 it ran out of the card's memory on both; at 1 it peaks
# at 66.5 GB allocated and 84.2 reserved on mamba2, 55.9 and 70.3 on
# zamba2; H100 80GB HBM3, 700 W)
SSM_TRAIN = dict(n_data=64, q=0.125, target_eps=8.0, seq_len=1024,
                 smoke=False)
# the record engines against masked_pe on one physical batch, per model,
# set before the first run on the card from the CPU's bf16 values
# (compare_record_engines on a physical batch of 4: reduced mamba2 and the
# narrow hybrid (2 supers of 2, a tail of 1) at T = 128, seed 0; two-layer
# cuts at full width, d 2,048, vocab 4,096, T = 256, seeds 0 and 1) and
# the card-over-CPU ratios the ViT and DenseLM showed (ghost 1.5-2x of
# max |acc| and 1.75-6x on the worst leaf; BK 1.2-3x of max |acc|, 0.6-0.7x
# on the worst leaf):
# * masked_ghost: mamba2 8.9e-3 to 1.1e-2 of max |acc|, zamba2 1.4e-2 to
#   1.5e-2, so 2e-2 to 3e-2 expected: 5e-2; worst leaf (gains, D, dt_bias,
#   shared.ln1) 1.4e-2 to 2.1e-2, so up to 1.2e-1 expected: 2e-1, still 5x
#   below the O(1) of a zeroed or wrong leaf;
# * masked_bk: mamba2 3.7e-4 to 3.4e-3 of max |acc|, so up to 1e-2
#   expected: 3e-2; zamba2 3.0e-4 to 8.2e-4: DenseLM's 2e-2; worst leaf
#   3.4e-3 to 4.5e-3 on both: 2e-2;
# * the "ghost" stream source: 2.2e-7 to 6.9e-7, worst leaf up to 1.2e-6:
#   the ViT's 1e-4 and 1e-3; the norms up to 8.7e-7 relative: 1e-3;
# * the forced direct path against the Gram path: 4e-7 at T = 128 to
#   1.5e-6 at T_eff = 512 (it grows with T; DenseLM's was 1.05e-5 at
#   1,024): the ViT's 1e-4
# zamba2's values all fall inside DENSELM_LIMITS, which it is held to;
# mamba2's BK needs 3e-2 of max |acc|
MAMBA2_LIMITS = {
    "pe": {"masked_ghost": 5e-2, "masked_bk": 3e-2,
           "masked_fused_stream_ghost": 1e-4},
    "leaf": {"masked_ghost": 2e-1, "masked_bk": 2e-2,
             "masked_fused_stream_ghost": 1e-3},
    "norms": 1e-3, "forced": 1e-4}
SSM_MODELS = {
    "mamba2-1.3b": dict(
        params=1_446_505_472, physical_batch=1, limits=MAMBA2_LIMITS,
        # at T = 1,024 every dense takes the Gram path (in_proj 2,048 x
        # 8,512 and out_proj 4,096 x 2,048 go direct only above T = 4,175
        # and 2,896): the kernel runs in the forced-path check alone
        direct_per_pass=0,
        fits=(("masked_pe", 2), ("masked_ghost", 2), ("masked_bk", 2),
              ("masked_fused_stream", 2), ("masked_fused", 1),
              ("nonprivate", 1)),
        ghost_shapes={"mamba2_in_proj": (1024, 2048, 8512),
                      "mamba2_out_proj": (1024, 4096, 2048)}),
    "zamba2-1.2b": dict(
        params=1_170_313_344, physical_batch=1, limits=DENSELM_LIMITS,
        # the shared block's records fold its 6 uses into T_eff = 6,144
        # (T_eff^2 = 37.7M above every din dout): wq, wk, wv, wo (2,048 x
        # 2,048), w1, w3 (2,048 x 8,192) and w2 (8,192 x 2,048) take the
        # kernel, once each per norm pass; the mamba denses and the head
        # take the Gram path
        direct_per_pass=7,
        fits=(("masked_ghost", 2), ("masked_bk", 2),
              ("masked_fused_stream", 2), ("nonprivate", 1)),
        ghost_shapes={"zamba2_attn": (6144, 2048, 2048),
                      "zamba2_w1_w3": (6144, 2048, 8192),
                      "zamba2_w2": (6144, 8192, 2048)}),
}
# SSD on one layer's real activations (f32): the chunked scan against a
# per-token ssd_step loop and against chunk 16, at the reference's bounds
# (tests/test_flashattn.py: rtol 2e-4, atol 2e-5, elementwise)
SSD_RTOL, SSD_ATOL = 2e-4, 2e-5
SSD_SMALL_CHUNK = 16


def _ssd_close(a, b) -> dict:
    """a against b elementwise: the largest |a - b| and its largest share
    of atol + rtol |b| (at most 1 passes)."""
    d = (a - b).abs()
    return {"max_abs_err": float(d.max()),
            "max_share_of_bound": float((d / (SSD_ATOL + SSD_RTOL
                                              * b.abs())).max())}


def check_ssd(session):
    """ssd_chunked on the first mamba layer's real inputs (the embedding of
    the fixed batch through the layer's norm, in_proj, conv and gates, the
    session's weights), in f32, at the config's chunk against a per-token
    loop of ssd_step and against SSD_SMALL_CHUNK: outputs and final
    states.  On zamba2 the layer is the first super's first inner mamba
    layer, fed the embedding directly: the shared block that runs before it
    in the model is skipped."""
    import torch
    from repro_torch.core.tape import Tape
    from repro_torch.models import common as cm
    from repro_torch.models.mamba2 import _mamba_pre, ssd_chunked, ssd_step

    cfg, p = session.model_cfg, session.state.params
    batch, _ = _fixed_batch(session)
    prefix, lead = (("blocks", 1) if cfg.family == "ssm"
                    else ("supers.inner", 2))
    lp = {k[len(prefix) + 1:]: v[(0,) * lead] for k, v in p.items()
          if k.startswith(prefix + ".")}
    with torch.no_grad():
        x = p["emb.w"][batch["tokens"].long()].to(cfg.act_dtype)
        h = cm.rmsnorm(Tape(), "ln", x, cm.sub_params(lp, "ln"), path="ln")
        _, xs, Bm, Cm, dt, u = _mamba_pre(Tape(), "m", "m",
                                          cm.sub_params(lp, "mamba"), h, cfg)
        B, T = xs.shape[:2]
        args = [a.float() for a in (xs.reshape(B, T, cfg.nheads_ssm,
                                               cfg.ssm_head_dim),
                                    dt, u, Bm, Cm)]
        del x, h, xs, Bm, Cm, dt, u
        y, s = ssd_chunked(*args, cfg.ssm_chunk)
        y_small, s_small = ssd_chunked(*args, SSD_SMALL_CHUNK)
        state = torch.zeros_like(s)
        ys = []
        for t in range(T):
            yt, state = ssd_step(state, *(a[:, t] for a in args))
            ys.append(yt)
        y_step = torch.stack(ys, dim=1)
    res = {"shape": list(args[0].shape), "state": list(s.shape),
           "chunk": cfg.ssm_chunk, "max_abs_y": float(y.abs().max()),
           "step_y": _ssd_close(y, y_step), "step_state": _ssd_close(
               s, state),
           f"chunk{SSD_SMALL_CHUNK}_y": _ssd_close(y, y_small),
           f"chunk{SSD_SMALL_CHUNK}_state": _ssd_close(s, s_small)}
    for k, v in res.items():
        if isinstance(v, dict):
            assert v["max_share_of_bound"] <= 1.0, (k, res)
    assert bool(torch.isfinite(y).all()), res
    return res


def run_lm_model(cfg, spec, train_kw, device, timer, checks=None):
    """One model of phases 7, 8 and 9 (``cfg`` an ArchConfig, ``spec``
    its entry of SSM_MODELS, MOE_MODELS or FRONTEND_MODELS): the parameter
    count, the kernels at its shapes (over a flat buffer past
    BIG_FLAT_AT, held on windows), fit() per engine with its launches,
    the model's own ``checks`` (name -> function of a session), the
    engines on one physical batch, one norm pass and the accumulate
    times.  ``spec["prepare"]``, where given, runs on every session before
    it is used."""
    import torch
    from repro_torch.core import DPConfig
    from repro_torch.core.session import PrivacySession, TrainConfig
    from repro_torch.models import build
    from repro_torch.utils.params import FlatGradView

    arch = cfg.name
    stages, t_mark = {}, [time.perf_counter()]

    def mark(stage):
        """Seconds since the previous mark, under ``stage``."""
        now = time.perf_counter()
        stages[stage] = now - t_mark[0]
        t_mark[0] = now

    model = build(cfg, device=device)
    view = FlatGradView.for_params(model.params())
    del model
    torch.cuda.empty_cache()
    assert view.n_params == spec["params"], (arch, view.n_params)
    B = spec["physical_batch"]
    train = dict(train_kw, physical_batch=B)
    res = {"arch": arch, "n_layers": cfg.n_layers, "n_params": view.n_params,
           "flat": view.total, "leaves": len(view.names),
           "seq_len": train_kw["seq_len"], "physical_batch": B}
    log(f"{arch} at {cfg.n_layers} layers: {view.n_params} params in "
        f"{len(view.names)} leaves, flat {view.total}, physical batch {B}")
    mark("build")
    kernel_checks = {}
    # the direct-path (T, din, dout) at the physical batch
    gn_checks, gn_err = check_ghost_norm(
        device, timer, {k: (B,) + v for k, v in spec["ghost_shapes"].items()})
    kernel_checks["ghost_norm_dense"] = {"checks": gn_checks,
                                         "max_abs_err": gn_err}
    log(f"{arch} ghost_norm_dense: {json.dumps(gn_checks)}")
    mark("ghost_norm_dense")
    torch.cuda.empty_cache()
    leaves, spans = held_windows(view)
    tree, tree_err = check_tree_noisy_update(view, device, (0x1234, 0xBEEF),
                                             leaves)
    kernel_checks["noisy_sgd_update"] = {"checks": {"tree": tree},
                                         "max_abs_err": tree_err}
    torch.cuda.empty_cache()
    nu_time, nu_checks = time_tree_update(view, device, timer)
    kernel_checks["noisy_sgd_update"]["checks"].update(nu_checks)
    kernel_checks["noisy_sgd_update"].update(nu_time)
    torch.cuda.empty_cache()
    ca_checks, ca_err, ca_time = check_clip_accum(view, device, B, timer,
                                                  spans)
    kernel_checks["clip_accum_inplace"] = {"checks": ca_checks,
                                           "max_abs_err": ca_err, **ca_time}
    torch.cuda.empty_cache()
    cr_checks, cr_err, cr_time = check_clip_accum_resident(view, device, B,
                                                           timer, spans)
    kernel_checks["clip_accum"] = {"checks": cr_checks, "max_abs_err": cr_err,
                                   **cr_time}
    torch.cuda.empty_cache()
    log(f"{arch} update and clip_accum: " + json.dumps(
        {k: v for k, v in kernel_checks.items() if k != "ghost_norm_dense"}))
    res["kernel_checks"] = kernel_checks
    mark("update_and_clip_accum")
    res["direct_denses_per_norm_pass"] = spec["direct_per_pass"]
    res["fit"] = {}
    session = None
    prepare = spec.get("prepare")
    for engine, steps in spec["fits"]:
        del session
        gc.collect()
        torch.cuda.empty_cache()
        session, rec, _ = run_fit(cfg, device, dict(train, steps=steps),
                                  engine,
                                  direct_denses=spec["direct_per_pass"],
                                  prepare=prepare)
        res["fit"][engine] = rec
        log(f"{arch} fit {engine}: {json.dumps(rec)}")
    mark("fits")
    # the checks and the accumulate times on a session without momentum
    del session
    gc.collect()
    torch.cuda.empty_cache()
    session = PrivacySession.from_config(
        cfg, DPConfig(engine="masked_pe", clip_norm=4.63),
        TrainConfig(**dict(train, steps=1, momentum=0.0)), device=device)
    if prepare is not None:
        prepare(session)
    for name, check in (checks or {}).items():
        res[name] = check(session)
        log(f"{arch} {name}: {json.dumps(res[name])}")
        mark(name)
        torch.cuda.empty_cache()
    res["record_engines"] = compare_record_engines(
        session, spec["limits"], stream_pe=True)
    mark("record_engines")
    torch.cuda.empty_cache()
    res["norm_pass"] = norm_pass_cost(session)
    log(f"{arch} norm pass: {json.dumps(res['norm_pass'])}")
    assert res["norm_pass"]["ghost_norm_dense_calls"] == \
        spec["direct_per_pass"], res["norm_pass"]
    mark("norm_pass")
    torch.cuda.empty_cache()
    res["accumulate"] = time_accumulate(session)
    log(f"{arch} accumulate of one physical batch of {B} x "
        f"{train_kw['seq_len']} tokens, ms and ratio to nonprivate: "
        f"{json.dumps(res['accumulate'])}")
    mark("accumulate")
    res["stage_seconds"] = stages
    del session
    gc.collect()
    torch.cuda.empty_cache()
    return res


def run_ssm_model(arch, device, timer):
    """One model of phase 7, with the SSD check."""
    from repro_torch.configs import get_config
    return run_lm_model(get_config(arch), SSM_MODELS[arch], SSM_TRAIN,
                        device, timer, checks={"ssd": check_ssd})


def run_ssm(device, timer):
    """Phase 7 (see the module docstring).  At one example a physical
    batch mamba2's per-example engines reach 79 GB reserved: every session
    is collected (``gc.collect``) before the next is built."""
    t0 = time.perf_counter()
    res = {arch: run_ssm_model(arch, device, timer) for arch in SSM_MODELS}
    res["seconds"] = time.perf_counter() - t0
    return res


# --------------------------------------------------------------------------
# phase 8: the MoE family
# --------------------------------------------------------------------------

# full-width olmoe-1b-7b and deepseek-v2-lite-16b (the reference's configs:
# every width, expert count, top-k, capacity factor and vocab), bf16
# activations, f32 params, random weights from the seed, at 1,024 tokens;
# n 64, q 0.125, eps 8, clip 4.63.  Depth is the one cut: the f32 state
# (params, accumulator, momentum: 12 B a parameter) of olmoe's 16 layers is
# 83 GB, so 3 of them (1,464,744,704 params, 17.6 GB), and deepseek's
# leading dense layer and one MoE layer (2 of 27; 1,085,287,424 params, 13.0
# GB).  The physical batch is the largest of 2 and 1 at which masked_fused
# fits: 2 for both (at 2 its fit peaks at 41.4 GB allocated and 70.0
# reserved on olmoe; H100 80GB HBM3, 700 W)
MOE_TRAIN = dict(n_data=64, q=0.125, target_eps=8.0, seq_len=1024,
                 smoke=False)
MOE_FITS = (("masked_pe", 2), ("masked_ghost", 2), ("masked_bk", 2),
            ("masked_fused_stream", 2), ("masked_fused", 1),
            ("nonprivate", 1))
# the record engines against masked_pe on one physical batch, set before
# the first run on the card from the CPU's bf16 values (compare_record_
# engines on reduced olmoe and deepseek, a physical batch of 4 at T = 128,
# seed 0; and on two-layer cuts at full width, d 2,048 with MLA's and the
# experts' widths but 16 experts top-2 and a vocab of 4,096, a physical
# batch of 2 at T = 256, seeds 0 and 1) and the card-over-CPU ratios the
# ViT, DenseLM and the SSM models showed (ghost 1.5-2x of max |acc| and
# 1.75-6x on the worst leaf; BK 1.2-3x of max |acc|, 0.6-0.7x on the worst
# leaf):
# * masked_ghost: 9.1e-3 to 1.6e-2 of max |acc|, so up to 3.1e-2 expected:
#   5e-2; worst leaf (qk-norm gains, ckv_norm, ln1, the embedding) 1.3e-2
#   to 1.6e-2, so up to 9.4e-2 expected: 2e-1, still 5x below the O(1) of
#   a zeroed or wrong leaf;
# * masked_bk: 2.3e-4 to 2.5e-4 reduced, but 7.9e-3 to 9.9e-3 at full
#   width, where the largest entry and the worst leaf are both the
#   embedding's (the other families stayed below 3.4e-3): up to 3e-2
#   expected: 5e-2 of max |acc| and on the worst leaf;
# * the "ghost" stream source: 2.4e-7 to 3.2e-7 reduced, 6e-6 to 3.8e-5 at
#   full width (norms that differ by as much: 3.1e-5 to 4.2e-5, the
#   embedding's, the router's and wk's ghost norms against the per-example
#   grads' bf16 rounding), so up to 8e-5 expected: 2e-4; worst leaf up to
#   3.8e-5: 1e-3; the norms 1e-3;
# * the forced direct path against the Gram path: 4.2e-7 to 5.6e-7 at T =
#   128, 2.0e-6 to 2.1e-6 at 256 (the heads; it grows with T; DenseLM's
#   was 1.05e-5 at 1,024): the ViT's 1e-4
MOE_LIMITS = {
    "pe": {"masked_ghost": 5e-2, "masked_bk": 5e-2,
           "masked_fused_stream_ghost": 2e-4},
    "leaf": {"masked_ghost": 2e-1, "masked_bk": 5e-2,
             "masked_fused_stream_ghost": 1e-3},
    "norms": 1e-3, "forced": 1e-4}
MOE_MODELS = {
    "olmoe-1b-7b": dict(
        n_layers=3, params=1_464_744_704, physical_batch=2,
        limits=MOE_LIMITS, fits=MOE_FITS,
        # at T = 1,024 (T^2 = 1,048,576) each layer's router (2,048 x 64)
        # takes the kernel; attention (2,048 x 2,048), the head and every
        # expert dense (T = cap = 160) take the Gram path
        direct_per_pass=3,
        ghost_shapes={"olmoe_router": (1024, 2048, 64)}),
    "deepseek-v2-lite-16b": dict(
        n_layers=2, params=1_085_287_424, physical_batch=2,
        limits=MOE_LIMITS, fits=MOE_FITS,
        # the MoE layer's router and both layers' RoPE key wkr (2,048 x 64)
        # take the kernel; wdkv (2,048 x 512 = T^2) sits on the boundary
        # and takes the Gram path with every other dense (the experts at
        # T = cap = 120)
        direct_per_pass=3,
        ghost_shapes={"deepseek_router_wkr": (1024, 2048, 64)}),
}


def check_bk_embed_rerun(device):
    """BK's embedding grad (coef-scaled dY rows added into their tokens'
    table rows) at olmoe's vocab and width over (2, 1,024) tokens drawn
    from 64 ids, so every token repeats, run three times: bit-identical.
    ``index_add_`` on the same rows, which adds repeated tokens with
    atomics, is run three times beside it for the record."""
    import torch
    from repro_torch.core import layers
    from repro_torch.core.tape import LayerSpec

    gen = torch.Generator(device=device).manual_seed(5)
    V, d = 50304, 2048
    ids = torch.randint(0, 64, (2, 1024), generator=gen, device=device)
    dy = torch.randn(2, 1024, d, generator=gen, device=device)
    coef = torch.tensor([0.5, 1.0], device=device)
    spec = LayerSpec("embed", param_path="emb.w", meta=(("vocab", V),))
    runs = [layers.bk_grads(spec, {"ids": ids}, dy, coef)["emb.w"]
            for _ in range(3)]
    rows = (dy * coef[:, None, None]).reshape(-1, d)
    adds = [torch.zeros(V, d, device=device).index_add_(
        0, ids.reshape(-1), rows) for _ in range(3)]
    res = {"bitwise": all(same_bits(runs[0], r) for r in runs[1:]),
           "index_add_bitwise": all(same_bits(adds[0], a)
                                    for a in adds[1:]),
           "max_abs_vs_index_add": float((runs[0] - adds[0]).abs().max())}
    assert res["bitwise"], res
    return res


def run_moe(device, timer):
    """Phase 8 (see the module docstring): BK's embedding grad rerun on
    repeated tokens, then each MoE model at its cut depth; every session
    is collected before the next is built."""
    import dataclasses

    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    res = {"bk_embed_rerun": check_bk_embed_rerun(device)}
    log(f"bk embedding grad reruns: {json.dumps(res['bk_embed_rerun'])}")
    res.update({arch: run_lm_model(
        dataclasses.replace(get_config(arch), n_layers=spec["n_layers"]),
        spec, MOE_TRAIN, device, timer)
        for arch, spec in MOE_MODELS.items()})
    res["seconds"] = time.perf_counter() - t0
    return res


# --------------------------------------------------------------------------
# phase 9: the frontend families
# --------------------------------------------------------------------------

# the VLM's gates (one 0-d scalar per super) before every fit and check:
# the reference initialises them to 0, which makes the cross attention's
# and proj's gradients exactly zero, so every check on fresh weights
# would hold zero against zero on those leaves
VLM_GATE = 0.5
FRONTEND_FITS = (("masked_pe", 2), ("masked_ghost", 2), ("masked_bk", 2),
                 ("masked_fused_stream", 2), ("masked_fused", 1),
                 ("nonprivate", 1))
# the record engines against masked_pe on one physical batch, set before
# the first run on the card from the CPU's bf16 values (compare_record_
# engines with stream_pe: reduced whisper-base at 192 frames and 16 tokens,
# a physical batch of 4; whisper two-layer cuts at full width, d 512, with
# a vocab of 4,096 at 300 frames and T = 64 (B = 2, seeds 0 and 1) and
# with the full vocab at 1,500 frames and T = 448 (B = 2 and 4); the
# reduced VLM at T = 128 (B = 4 and 1); a VLM cut at d 512 (8 heads over
# 2 KV heads, d_ff 1,792, 64 image tokens of 160, vocab 4,096, T = 128;
# B = 2 seeds 0 and 1, B = 1), its gates at VLM_GATE) and the card-over-CPU
# ratios the earlier families showed (ghost 1.5-2x of max |acc| and
# 1.75-6x on the worst leaf; BK 1.2-3x of max |acc|, 0.6-0.7x on the worst
# leaf):
# * masked_ghost: whisper 2.1e-3 to 4.9e-3 of max |acc|, the VLM 1.0e-2 to
#   1.5e-2, so up to 3e-2 expected: 5e-2.  Worst leaf: at whisper's full
#   vocab 4.1e-3 to 4.4e-3, but 7.5e-2 to 1.4e-1 at a vocab of 4,096 (the
#   key biases, whose true gradient is 0: rounding noise on both sides,
#   against the floor of 1e-3 of a smaller max |acc|), and on the VLM up to
#   1.2e-1 on the gate (one scalar summed over every token and width).  The
#   first two card runs read 1.5e-2 (whisper, dec_blocks.attn.wk.b) and
#   1.4e-2 (the VLM, emb.w) at the card's shapes, the same in both: 1e-1,
#   about 7x those and a tenth of the 1.0 of a zeroed leaf (a wrong one
#   reads O(1));
# * masked_bk: 1.8e-4 to 1.2e-3 of max |acc|, so up to 3.6e-3 expected:
#   DenseLM's 2e-2; worst leaf 2.8e-3 to 1.4e-2 (the gate again; the layer
#   norms' gains): the MoE phase's 5e-2;
# * the "ghost" stream source: up to 2.7e-6 of max |acc| and on the worst
#   leaf (0 at 1,500 frames): the MoE phase's 2e-4 and 1e-3; the norms up
#   to 2.1e-6 relative: 1e-3;
# * the forced direct path against the Gram path: up to 1.8e-6 (6.2e-7 at
#   1,500 frames; it grows with T and width, DenseLM's 1.05e-5 on the card
#   at 1,024): the ViT's 1e-4
FRONTEND_LIMITS = {
    "pe": {"masked_ghost": 5e-2, "masked_bk": 2e-2,
           "masked_fused_stream_ghost": 2e-4},
    "leaf": {"masked_ghost": 1e-1, "masked_bk": 5e-2,
             "masked_fused_stream_ghost": 1e-3},
    "norms": 1e-3, "forced": 1e-4}


def set_vlm_gates(session):
    """Every gate of the session's VLM to VLM_GATE, in place (the session's
    parameters are the model's own storage)."""
    import torch
    with torch.no_grad():
        session.state.params["supers.crossb.gate.w"].fill_(VLM_GATE)


FRONTEND_MODELS = {
    # full width and full depth: 6 encoder and 6 decoder layers, d 512, 8
    # heads, d_ff 2,048, vocab 51,865, 1,500 frames of d 512; the decoder
    # at 448 tokens, the published Whisper's text context.  The physical
    # batch is the largest of 32, 16 and 8 at which masked_fused fits,
    # reckoned before the first card call: under vmap(grad) one example
    # keeps about 6.5 GB (the encoder's f32 scores, 72 MB a copy, about ten
    # copies a layer over 6 layers, DenseLM's ratio; the decoder's and the
    # head's 2 GB more), so 8 examples about 52 GB and 16 about 104
    "whisper-base": dict(
        params=97_241_088, physical_batch=8, seq_len=448,
        limits=FRONTEND_LIMITS, fits=FRONTEND_FITS,
        # at 1,500 frames T^2 = 2.25M exceeds din dout of every encoder
        # dense (512 x 512, 512 x 2,048) and of the decoder's cross-attention
        # wk, wv, whose records are the frames: 6 x 6 + 6 x 2 kernel calls
        # a norm pass; the decoder's other denses (T = 448) and the head
        # take the Gram path
        direct_per_pass=48,
        ghost_shapes={"whisper_attn": (1500, 512, 512),
                      "whisper_w1": (1500, 512, 2048),
                      "whisper_w2": (1500, 2048, 512)}),
    # every width, the vocab, 1,601 image tokens of 1,280 and rope_theta
    # the config's; depth cut to n_layers 2 with cross_every 2 (the
    # reference's own reduced() sets cross_every 2): one self-attention
    # SwiGLU layer and one gated cross-attention layer.  One super block
    # at the config's cross_every 5 is 6.39G params (25.6 GB a f32 copy);
    # params, accumulator and one example's grads would be 77 GB.  At
    # 3,823,149,057 params each f32 copy is 15.3 GB; no momentum (a third
    # copy), a physical batch of 1.  Reckoned peaks (GB): state 30.6; pe,
    # fused and the stream add the example's grads (15.3) and a second
    # flat copy (the fold's sum, the (1, D) matrix, the tile) for 61-66;
    # ghost and nonprivate a grad tree and about 11 GB of activations for
    # 57; BK 51: all six fit
    "llama-3.2-vision-90b": dict(
        n_layers=2, cross_every=2, params=3_823_149_057, physical_batch=1,
        seq_len=1024, momentum=0.0,
        limits=FRONTEND_LIMITS, prepare=set_vlm_gates,
        fits=tuple((e, 1) for e, _ in FRONTEND_FITS),
        # at T = 1,024 every dense takes the Gram path (T^2 = 1.05M below
        # every din dout; the cross attention's wk, wv at 1,601 image tokens
        # 2.56M below 8,192 x 1,024, proj's 2.56M below 1,280 x 8,192): the
        # kernel runs in the forced-path check alone
        direct_per_pass=0, ghost_shapes={}),
}
FRONTEND_TRAIN = dict(n_data=64, q=0.125, target_eps=8.0, smoke=False)


def held_windows(view):
    """Where the update's and the clip kernels' checks hold each kernel
    against its plain version: (None, None), the whole buffer, up to
    BIG_FLAT_AT; past it the leaf that holds element BIG_FLAT_AT and the
    last leaf (the update's leaf indices; it leaves the pad alone), and
    that leaf's span and the buffer's last BIG_FLAT_TAIL elements (the clip
    kernels' spans)."""
    if view.total <= BIG_FLAT_AT:
        return None, None
    i = next(i for i, (o, n) in enumerate(zip(view.offsets, view.sizes))
             if o <= BIG_FLAT_AT < o + n)
    return ([i, len(view.names) - 1],
            [(view.offsets[i], view.offsets[i] + view.sizes[i]),
             (view.total - BIG_FLAT_TAIL, view.total)])


def run_frontend(device, timer):
    """Phase 9 (see the module docstring): whisper-base, then the VLM cut;
    every session is collected before the next is built."""
    import dataclasses

    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    res = {}
    for arch, spec in FRONTEND_MODELS.items():
        over = {k: spec[k] for k in ("n_layers", "cross_every") if k in spec}
        cfg = dataclasses.replace(get_config(arch), **over)
        train = dict(FRONTEND_TRAIN, seq_len=spec["seq_len"],
                     **{k: spec[k] for k in ("momentum",) if k in spec})
        res[arch] = run_lm_model(cfg, spec, train, device, timer)
    res["seconds"] = time.perf_counter() - t0
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.costmodel import (free_memory_bytes,
                                              stream_tile_size)
    from repro_torch.models import build
    from repro_torch.utils.device import resolve_device
    from repro_torch.utils.params import FlatGradView

    t_start = time.perf_counter()
    record = {}
    # 1. device
    device = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    log(f"device {name}, capability {cap}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    assert cap == (9, 0), f"need an sm_90 card, got capability {cap}"
    record["device"] = {"name": name, "nvidia_smi": smi,
                        "torch": torch.__version__, "cuda": torch.version.cuda}
    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    record["build_seconds"] = time.perf_counter() - t0
    log(f"built {sorted(libs)} in {record['build_seconds']:.1f} s")
    record["kernel_resources"] = kernel_resources(libs)
    log(f"kernel resources: {json.dumps(record['kernel_resources'])}")
    # 3. kernels at ViT-Base shapes
    cfg = get_config("vit-base")
    model = build(cfg, device=device)
    view = FlatGradView.for_params(model.params())
    del model
    train_kw = dict(steps=3, n_data=512, q=0.125, physical_batch=32,
                    target_eps=8.0, smoke=False)
    tile = stream_tile_size(train_kw["physical_batch"], view.n_params,
                            free_memory_bytes(device))
    log(f"ViT-Base: {view.n_params} params, flat {view.total}, "
        f"stream tile {tile}")
    nu_checks, nu_err, nu_time = check_noisy_update(view, device, cuda_ms)
    log(f"noisy_sgd_update: {json.dumps(nu_checks)} {json.dumps(nu_time)}")
    ca_checks, ca_err, ca_time = check_clip_accum(view, device, tile, cuda_ms)
    log(f"clip_accum_inplace: {json.dumps(ca_checks)} {json.dumps(ca_time)}")
    torch.cuda.empty_cache()
    gn_checks, gn_err = check_ghost_norm(device, cuda_ms)
    log(f"ghost_norm_dense: {json.dumps(gn_checks)}")
    cr_checks, cr_err, cr_time = check_clip_accum_resident(
        view, device, train_kw["physical_batch"], cuda_ms)
    log(f"clip_accum: {json.dumps(cr_checks)} {json.dumps(cr_time)}")
    record["kernel_checks"] = {"noisy_sgd_update": nu_checks,
                               "clip_accum_inplace": ca_checks,
                               "ghost_norm_dense": gn_checks,
                               "clip_accum": cr_checks}
    torch.cuda.empty_cache()
    # 4. fit() at full width per engine, each with its counters set to 0
    # just before and read just after; then the engines on one batch, the
    # accumulate times and the CLI
    record["fit"] = {}
    session = None
    for engine, steps in (("masked_fused_stream", 3), ("masked_ghost", 3),
                          ("masked_bk", 3), ("masked_fused", 1)):
        del session
        torch.cuda.empty_cache()
        # the head (T = 1) is ViT-Base's one direct-path dense
        session, rec, _ = run_fit("vit-base", device,
                                  dict(train_kw, steps=steps), engine,
                                  direct_denses=1)
        record["fit"][engine] = rec
        log(f"fit {engine}: {json.dumps(rec)}")
        if engine == "masked_fused_stream":
            record["engines"] = compare_engines(
                session, rec["stream_tile"] or tile)
            log(f"masked_pe vs masked_fused_stream: "
                f"{json.dumps(record['engines'])}")
    record["record_engines"] = compare_record_engines(session, VIT_LIMITS)
    torch.cuda.empty_cache()
    record["accumulate"] = time_accumulate(session)
    log(f"accumulate of one physical batch of "
        f"{train_kw['physical_batch']}, ms and ratio to nonprivate: "
        f"{json.dumps(record['accumulate'])}")
    del session
    torch.cuda.empty_cache()
    record["cli"] = {}
    for engine in ("masked_pe", "masked_ghost", "masked_bk", "masked_fused"):
        record["cli"][engine] = run_cli(device, ["--arch", "vit-base"],
                                        engine)
        log(f"cli {engine}: {json.dumps(record['cli'][engine])}")
    record["allocated_bytes_after_phase"] = after = {}

    def phase_end(phase):
        """What is still allocated once a phase has released its work."""
        after[phase] = torch.cuda.memory_allocated(device)
        log(f"after phase {phase}: {after[phase] / 1e9:.3f} GB allocated, "
            f"{torch.cuda.memory_reserved(device) / 1e9:.3f} GB reserved")

    phase_end("4")
    # 5. full-width qwen2-0.5b at 1,024 tokens
    record["denselm"] = run_denselm(device, cuda_ms)
    torch.cuda.empty_cache()
    phase_end("5")
    # 6. the training lifecycle on full-width ViT-Base
    record["lifecycle"] = life = run_lifecycle(device, cuda_ms, view)
    log(f"lifecycle phase: {life['seconds']:.1f} s")
    torch.cuda.empty_cache()
    phase_end("6")
    # 7. full-width mamba2-1.3b and zamba2-1.2b at 1,024 tokens
    record["ssm"] = ssm = run_ssm(device, cuda_ms)
    log(f"ssm phase: {ssm['seconds']:.1f} s")
    phase_end("7")
    # 8. full-width olmoe-1b-7b and deepseek-v2-lite-16b at 1,024 tokens
    record["moe"] = moe = run_moe(device, cuda_ms)
    log(f"moe phase: {moe['seconds']:.1f} s")
    phase_end("8")
    # 9. full-width whisper-base and the VLM cut
    record["frontend"] = front = run_frontend(device, cuda_ms)
    log(f"frontend phase: {front['seconds']:.1f} s")
    phase_end("9")
    # the kernels line: launches summed over every fit() run, ViT's,
    # DenseLM's, the lifecycle's, the SSM, MoE and frontend phases' (the
    # chaos runs' own processes aside)
    counted = [r["launches"] for r in (*record["fit"].values(),
                                       *record["denselm"]["fit"].values(),
                                       *life["fits"].values())]
    counted += [life["checkpoint"]["launches"],
                life["protocol"]["launches"]]
    counted += [r["launches"] for phase, models in (
                    (ssm, SSM_MODELS), (moe, MOE_MODELS),
                    (front, FRONTEND_MODELS))
                for arch in models for r in phase[arch]["fit"].values()]
    launches = {k: sum(c[k] for c in counted) for k in kernel_wrappers()}
    _, no_time = life["noise_only"]
    kernels = [
        {"name": "noisy_sgd_update", "route": "cuda",
         "source": "src/repro_torch/csrc/noisy_update.cu",
         "replaces": "src/repro/kernels/noisy_update.py:166",
         "launches": launches["noisy_sgd_update"], "max_abs_err": nu_err,
         **nu_time,
         "noise_only": {"launches": launches["noise_only"], **no_time}},
        {"name": "clip_accum_inplace", "route": "cuda",
         "source": "src/repro_torch/csrc/clip_accum.cu",
         "replaces": "src/repro/kernels/clip_accum.py:125",
         "launches": launches["clip_accum_inplace"], "max_abs_err": ca_err,
         **ca_time},
        {"name": "ghost_norm_dense", "route": "cuda",
         "source": "src/repro_torch/csrc/ghost_norm.cu",
         "replaces": "src/repro/kernels/ghost_norm.py:52",
         "launches": launches["ghost_norm_dense"], "max_abs_err": gn_err,
         **{k: gn_checks["head_bfloat16"][k] for k in
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        {"name": "clip_accum", "route": "cuda",
         "source": "src/repro_torch/csrc/clip_accum.cu",
         "replaces": "src/repro/kernels/clip_accum.py:72",
         "launches": launches["clip_accum"], "max_abs_err": cr_err,
         **cr_time},
    ]
    record["kernels"] = kernels
    record["seconds"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"done in {record['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
