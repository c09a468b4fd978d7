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
               (the paper's overhead ratio); and the training CLI with
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
               against ``nonprivate``; and the training CLI at 1,024 tokens.

The line before the last lists the kernels as JSON (launches summed over
every ``fit()``, ViT's and DenseLM's; times at ViT-Base's main-path
shapes, DenseLM's in the record); the last line is
``{"ok": true, "device": {...}}``.  The full record goes to
``chiprun_out/chip_smoke.json``.  Without a CUDA device, or run outside a
checkout of the repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

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
    step, its host work, and the noise-free step's time."""
    import torch
    from repro_torch.kernels import noisy_update as nu

    gen = torch.Generator(device=device).manual_seed(1)
    checks = {}
    params = {nm: torch.randn(view.shapes[i], generator=gen, device=device)
              for i, nm in enumerate(view.names)}
    acc = torch.randn(view.total, generator=gen, device=device)
    mom = torch.zeros(view.total, device=device)

    def kernel_step(seeds=seed):
        nu.tree_noisy_update(params, acc, seeds, 2.3, 64.0, 1e-3, view=view,
                             momentum_buf=mom, momentum=0.9)

    sc, inv_l, lr, mu = nu.update_scalars(2.3, 64.0, 1e-3, 0.9)

    def plain_step():
        for i, nm in enumerate(view.names):
            o, n = view.offsets[i], view.sizes[i]
            nu.noisy_sgd_update_plain(
                params[nm].view(-1), acc[o:o + n],
                nu.threefry_normal(nu.leaf_seed(seed, i), n, device), sc,
                inv_l, lr, mom[o:o + n], mu)

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
    timing = {"ms": timer(kernel_step, 20), "plain_ms": timer(plain_step, 3),
              "bound_ms": bms, "bound_by": by, "library_ms": None}
    checks["host_us_per_step"] = host_us(kernel_step, 20)
    # the same step without noise: p, acc and m read, p and m written, the
    # same 20 B/param as the Threefry step: what the in-kernel Threefry and
    # Box-Muller cost on top of the memory traffic
    checks["noise_free_ms"] = timer(lambda: kernel_step(None), 20)
    checks["noise_free_bound_ms"] = bound_ms(20.0 * n_par)[0]
    return timing, checks


def check_tree_noisy_update(view, device, seed):
    """The one-launch tree_noisy_update against the per-leaf plain update
    on every leaf of ``view``: each noise kind, with and without momentum;
    bitwise for the operand and noise-free forms, the Threefry form within
    the normals' bound (params and momentum to 1e-6)."""
    import torch
    from repro_torch.kernels import noisy_update as nu

    gen = torch.Generator(device=device).manual_seed(5)
    p0 = {nm: torch.randn(view.shapes[i], generator=gen, device=device)
          for i, nm in enumerate(view.names)}
    acc = torch.randn(view.total, generator=gen, device=device)
    z = torch.randn(view.total, generator=gen, device=device)
    m0 = torch.randn(view.total, generator=gen, device=device)
    args = (2.3, 64.0, 1e-3)
    res, max_err = {}, 0.0
    for mom in (0.0, 0.9):
        sc, inv_l, lr, mu = nu.update_scalars(*args, mom)
        for kind in ("operand", "none", "threefry"):
            pk = {nm: t.clone() for nm, t in p0.items()}
            pp = {nm: t.clone() for nm, t in p0.items()}
            mk = m0.clone() if mom else None
            mp = m0.clone() if mom else None
            nu.tree_noisy_update(
                pk, acc, seed if kind != "none" else None, *args, view=view,
                momentum_buf=mk, momentum=mom,
                noise=z if kind == "operand" else None)
            for i, nm in enumerate(view.names):
                o, n = view.offsets[i], view.sizes[i]
                zz = (z[o:o + n] if kind == "operand" else
                      nu.threefry_normal(nu.leaf_seed(seed, i), n, device)
                      if kind == "threefry" else None)
                nu.noisy_sgd_update_plain(pp[nm].view(-1), acc[o:o + n], zz,
                                          sc, inv_l, lr,
                                          mp[o:o + n] if mom else None, mu)
            fk, fp = view.flatten(pk), view.flatten(pp)
            err = float((fk - fp).abs().max())
            bitwise = same_bits(fk, fp)
            if mom:
                err = max(err, float((mk - mp).abs().max()))
                bitwise = bitwise and same_bits(mk, mp)
            key = f"{kind}_mom{mom}"
            res[key] = {"bitwise": bitwise, "max_abs_err": err}
            if kind != "threefry":
                assert bitwise, f"tree {key}: not bitwise {err}"
            else:
                assert err <= 1e-6, f"tree {key}: {err}"
            max_err = max(max_err, err)
            del pk, pp, mk, mp, fk, fp
    return res, max_err


def check_clip_accum(view, device, tile, timer):
    """clip_accum_inplace at the full flat length, m in {1, tile}."""
    import torch
    from repro_torch.kernels import clip_accum as ca

    gen = torch.Generator(device=device).manual_seed(2)
    d = view.total
    checks = {}
    max_err = 0.0
    timing = None
    for m in sorted({1, tile}):
        norms = torch.rand(m, generator=gen, device=device) * 9.0
        norms[0] = 0.0
        mask = (torch.rand(m, generator=gen, device=device) > 0.25).float()
        mask[0] = 1.0
        acc0 = torch.randn(d, generator=gen, device=device)
        for dt in (torch.float32, torch.bfloat16):
            g = torch.randn(m, d, generator=gen, device=device).to(dt)
            ak, ap = acc0.clone(), acc0.clone()
            ca.clip_accum_inplace(ak, g, norms, mask, 4.63)
            ca.clip_accum_inplace_plain(ap, g, norms, mask, 4.63)
            err = float((ak - ap).abs().max())
            key = f"m{m}_{str(dt).split('.')[-1]}"
            checks[key] = {"bitwise": same_bits(ak, ap), "max_abs_err": err}
            assert checks[key]["bitwise"], f"clip_accum_inplace {key}: {err}"
            max_err = max(max_err, err)
            if m == tile and dt == torch.float32:
                coef = ca.clip_coefs(norms, mask, 4.63)
                bms, by = bound_ms((4.0 * m + 8.0) * d, 2.0 * m * d)
                timing = {
                    "ms": timer(lambda: ca.clip_accum_inplace(
                        ak, g, norms, mask, 4.63), 10),
                    "plain_ms": timer(lambda: ca.clip_accum_inplace_plain(
                        ap, g, norms, mask, 4.63), 3),
                    "bound_ms": bms, "bound_by": by,
                    # one PyTorch call computing the same function on the
                    # same inputs (another summation order): the yardstick
                    "library_ms": timer(lambda: ap.addmv_(g.T, coef), 10)}
            del g, ak, ap
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
    for label, (B, T, di, do) in (shapes or GHOST_NORM_SHAPES).items():
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


def check_clip_accum_resident(view, device, batch, timer):
    """The resident clip_accum at (batch, flat length), f32 and bf16,
    bitwise against its plain version; timed in f32 (the per-example grads'
    dtype on the main path)."""
    import torch
    from repro_torch.kernels import clip_accum as ca

    gen = torch.Generator(device=device).manual_seed(4)
    d, m = view.total, batch
    norms = torch.rand(m, generator=gen, device=device) * 9.0
    norms[0] = 0.0
    mask = (torch.rand(m, generator=gen, device=device) > 0.25).float()
    mask[0] = 1.0
    checks, max_err, timing = {}, 0.0, None
    for dt in (torch.float32, torch.bfloat16):
        g = torch.randn(m, d, generator=gen, device=device).to(dt)
        k = ca.clip_accum(g, norms, mask, 4.63)
        p = ca.clip_accum_plain(g, norms, mask, 4.63)
        err = float((k - p).abs().max())
        key = f"m{m}_{str(dt).split('.')[-1]}"
        checks[key] = {"bitwise": same_bits(k, p), "max_abs_err": err}
        assert checks[key]["bitwise"], f"clip_accum {key}: {err}"
        max_err = max(max_err, err)
        if dt == torch.float32:
            coef = ca.clip_coefs(norms, mask, 4.63)
            bms, by = bound_ms((4.0 * m + 4.0) * d, 2.0 * m * d)
            timing = {
                "ms": timer(lambda: ca.clip_accum(g, norms, mask, 4.63), 10),
                "plain_ms": timer(lambda: ca.clip_accum_plain(
                    g, norms, mask, 4.63), 3),
                "bound_ms": bms, "bound_by": by,
                # one PyTorch call computing the same function on the same
                # inputs (another summation order): the yardstick
                "library_ms": timer(lambda: coef @ g, 10)}
        del g, k, p
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
}


def kernel_wrappers():
    """name -> the wrapper whose ``launches`` counts that kernel."""
    from repro_torch.kernels import clip_accum as ca
    from repro_torch.kernels import ghost_norm as gn
    from repro_torch.kernels import noisy_update as nu
    return {"noisy_sgd_update": nu.noisy_sgd_update,
            "clip_accum_inplace": ca.clip_accum_inplace,
            "ghost_norm_dense": gn.ghost_norm_dense,
            "clip_accum": ca.clip_accum}


def run_fit(arch, device, train_kw, engine="masked_fused_stream",
            direct_denses=0):
    """fit() with ``engine``; every kernel counter is set to 0 just before
    and read just after.  ``direct_denses`` is the number of dense layers
    the Mixed-Ghost rule sends to the kernel in one norm pass: a record
    engine must launch ``ghost_norm_dense`` exactly that many times per
    physical batch (one norm pass each), the other engines never.
    Returns (session, record, launches)."""
    import torch
    from repro_torch.core import DPConfig
    from repro_torch.core.session import PrivacySession, TrainConfig
    from repro_torch.privacy import epsilon_for

    tc = TrainConfig(**train_kw)
    session = PrivacySession.from_config(
        arch, DPConfig(engine=engine, clip_norm=4.63), tc, device=device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize()
        retries = alloc_retries(device)
    # one accumulate per physical batch: one norm pass of a record engine
    accumulate, passes = session._accumulate, []

    def counted(*args):
        passes.append(1)
        return accumulate(*args)

    session._accumulate = counted
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = session.fit()
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    # a wrapper counts where it launches its kernel: on the card only
    for name in ENGINE_KERNELS[engine] if cuda else ():
        assert launches[name] > 0, f"fit() with {engine} launched {name} " \
                                   f"no time"
    session._accumulate = accumulate
    record_based = session.describe()["engine_traits"]["record_based"]
    ghost_launches = direct_denses * len(passes) if record_based else 0
    if cuda:
        # the update is one launch per step over every leaf
        assert launches["noisy_sgd_update"] == tc.steps, (engine, launches)
        assert launches["ghost_norm_dense"] == ghost_launches, (
            engine, launches, len(passes), direct_denses)
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == tc.steps and all(map(math.isfinite, losses)), out
    assert all(bool(torch.isfinite(p).all())
               for p in session.state.params.values()), "non-finite params"
    eps = epsilon_for(tc.sampler, session.describe()["q"],
                      session.dp.noise_multiplier, tc.steps,
                      tc.resolved_delta)
    assert out["final_eps"] == eps, (out["final_eps"], eps)
    assert eps <= tc.target_eps, eps
    record = {"engine": engine, "steps": tc.steps,
              "history": out["history"], "sigma": out["sigma"],
              "final_eps": out["final_eps"], "fit_seconds": seconds,
              "examples": sum(h["logical_batch"] for h in out["history"]),
              "examples_per_s": out["examples_per_s"],
              "stream_tile": session.describe()["stream_tile"],
              "engine_traits": session.describe()["engine_traits"],
              "physical_batches": len(passes),
              "launches": launches,
              **(memory_record(device, retries) if cuda
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


def compare_record_engines(session, limits):
    """On one fixed physical batch: masked_fused (bitwise), masked_ghost,
    masked_bk and the streaming engine's "ghost" norm source against
    masked_pe, and every dense layer's ghost norm through the kernel
    (forced direct path) against the einsum (forced ghost path), held to
    ``limits`` (the model's named limits: "pe", "leaf" per engine, "norms",
    "forced")."""
    import torch
    from repro_torch.core import fused, layers
    from repro_torch.core.clipping import _eps_backward, resolve_engine
    from repro_torch.utils.params import FlatGradView

    batch, mask = _fixed_batch(session)
    params, loss_fn = session.state.params, session.loss_fn
    view = FlatGradView.for_params(params)
    run = {e: resolve_engine(e) for e in ("masked_pe", "masked_fused",
                                          "masked_ghost", "masked_bk")}
    def host_flat(summed):
        """The summed grads flattened on the host, their device copies
        released: at DenseLM's width the engines need the card's room."""
        acc = view.flatten(summed).cpu()
        summed.clear()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        return acc

    summed, pe_aux = run["masked_pe"](loss_fn, params, batch, mask, 4.63)
    acc_pe = host_flat(summed)
    scale = float(acc_pe.abs().max())
    pe_norms = pe_aux["per_example_norms"].cpu()
    res = {"max_abs_acc": scale}

    def against_pe(acc, norms):
        norms = norms.cpu()
        leaf = {}
        for nm, o, n in zip(view.names, view.offsets, view.sizes):
            a, p = acc[o:o + n], acc_pe[o:o + n]
            leaf[nm] = float((a - p).abs().max()) / max(
                float(p.abs().max()), LEAF_FLOOR * scale)
        worst = max(leaf, key=leaf.get)
        return {"bitwise": same_bits(acc, acc_pe),
                "max_abs_err": float((acc - acc_pe).abs().max()),
                "rel_to_max_acc": float((acc - acc_pe).abs().max()) / scale,
                "rel_l2_err": float((acc - acc_pe).norm() / acc_pe.norm()),
                "worst_leaf": worst, "worst_leaf_rel_err": leaf[worst],
                "norms_max_rel_err": float(((norms - pe_norms).abs()
                                            / pe_norms).max())}

    def hold(key, r):
        assert r["rel_to_max_acc"] <= limits["pe"][key], (key, r)
        assert r["worst_leaf_rel_err"] <= limits["leaf"][key], (key, r)
        assert r["norms_max_rel_err"] <= limits["norms"], (key, r)

    ghost_norms = None
    for e in ("masked_fused", "masked_ghost", "masked_bk"):
        kw = {"check_coverage": True} if e == "masked_bk" else {}
        summed, aux = run[e](loss_fn, params, batch, mask, 4.63, **kw)
        acc = host_flat(summed)
        res[e] = against_pe(acc, aux["per_example_norms"])
        if e == "masked_ghost":
            ghost_norms = aux["per_example_norms"]
        log(f"{e} vs masked_pe: {json.dumps(res[e])}")
        if e == "masked_fused":
            assert res[e]["bitwise"], res[e]
        else:
            hold(e, res[e])
        del acc
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
    r = against_pe(acc.cpu(), aux["per_example_norms"])
    r["norms_bitwise_vs_masked_ghost"] = same_bits(aux["per_example_norms"],
                                                   ghost_norms)
    res["masked_fused_stream_ghost"] = r
    log(f"masked_fused_stream (ghost norms) vs masked_pe: {json.dumps(r)}")
    hold("masked_fused_stream_ghost", r)
    assert r["norms_bitwise_vs_masked_ghost"], r
    del acc, acc_pe
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
    accumulates add into the session's own accumulator (zeroed per engine):
    at DenseLM's width the card has no room for a second one."""
    import torch
    from repro_torch.core.engine import DPConfig, build_accumulate_fn

    batch, mask = _fixed_batch(session)
    dev = session.device
    B = int(mask.shape[0])
    state = session.state
    res = {}
    for e in ACCUMULATE_ENGINES:
        acc_fn = build_accumulate_fn(session.loss_fn, DPConfig(
            engine=e, clip_norm=4.63,
            stream_tile=B if e == "masked_fused_stream" else None))
        state.grad_acc.zero_()
        acc_fn(state, batch, mask)
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            retries = alloc_retries(dev)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            acc_fn(state, batch, mask)
            if cuda:
                torch.cuda.synchronize(dev)
            times.append(1e3 * (time.perf_counter() - t0))
        res[e] = {"ms": sum(times) / iters, "min_ms": min(times),
                  "all_ms": times,
                  **(memory_record(dev, retries) if cuda
                     else {"peak_mem_bytes": None})}
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
        res.update({"kernel_device_us_all_calls": sum(ours),
                    "kernel_device_us_per_call": sum(ours) / max(len(ours),
                                                                 1),
                    "device_us_all_kernels": sum(k["us"] for k in kernels),
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
    # 5. full-width qwen2-0.5b at 1,024 tokens
    record["denselm"] = run_denselm(device, cuda_ms)
    # the kernels line: launches summed over every fit() run, ViT's and
    # DenseLM's
    fits = [*record["fit"].values(), *record["denselm"]["fit"].values()]
    launches = {k: sum(r["launches"][k] for r in fits)
                for k in kernel_wrappers()}
    kernels = [
        {"name": "noisy_sgd_update", "route": "cuda",
         "source": "src/repro_torch/csrc/noisy_update.cu",
         "replaces": "src/repro/kernels/noisy_update.py:166",
         "launches": launches["noisy_sgd_update"], "max_abs_err": nu_err,
         **nu_time},
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
