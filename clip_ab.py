#!/usr/bin/env python3
"""A/B of the clip kernels (``src/repro_torch/csrc/clip_accum.cu``) on one
H100, against an earlier source of the same file and against variants of the
current one.

    git show <commit>:src/repro_torch/csrc/clip_accum.cu > build/clip_ab/parent.cu
    python3 clip_ab.py --parent build/clip_ab/parent.cu [--accumulate]

The parent's source is the interface before the split (no head and vector
count).  The script builds it, the current source and each of VARIANTS (a
text substitution of the current source) with its own ``nvcc`` into the
git-ignored ``build/clip_ab/``; holds every build bitwise against the
parent's at each of SHAPES, both forms; and times them with CUDA events in
turns (parent, current, variants, variants reversed, current, parent) beside
the bound and ``chip_smoke.py``'s one-call yardsticks.  ``--accumulate``
then times one accumulate per engine of ACCUMULATE_ENGINES with the parent's
kernels and with the current ones, in turns (parent, current, current,
parent), on the models that run one or two rows (ACCUMULATE_MODELS).  Writes
``chiprun_out/clip_ab.json``.  Needs the card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "clip_ab"

# (label, rows, flat length): the rows and flat buffers of the main path's
# calls (chip_smoke.py's phases), f32 g
SHAPES = (("vit_m32", 32, 85_866_496), ("whisper_m8", 8, 97_241_088),
          ("denselm_m4", 4, 630_167_552), ("olmoe_m2", 2, 1_464_744_704),
          ("mamba2_m1", 1, 1_446_505_472), ("vlm_m1", 1, 3_823_149_312))
ACCUMULATE_ENGINES = ("nonprivate", "masked_fused", "masked_fused_stream")
ACCUMULATE_MODELS = ("llama-3.2-vision-90b", "olmoe-1b-7b", "mamba2-1.3b")

# the current source's persistent-grid form: the grid capped at the blocks
# the card holds at once (SMs times resident blocks), each block striding
# over the buffer
PERSISTENT = (
    ("  if (tid < head + (d_len - vend)) {\n"
     "    const int64_t d = tid < head ? tid : vend + (tid - head);",
     "  const int64_t n_threads = static_cast<int64_t>(gridDim.x) * kThreads;\n"
     "  for (int64_t i = tid; i < head + (d_len - vend); i += n_threads) {\n"
     "    const int64_t d = i < head ? i : vend + (i - head);"),
    ("  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * kThreads * kVecs +\n"
     "                     threadIdx.x;\n"
     "  if (v0 >= n_vec) return;",
     "  for (int64_t v0 = static_cast<int64_t>(blockIdx.x) * kThreads * kVecs +\n"
     "                    threadIdx.x;\n"
     "       v0 < n_vec; v0 += n_threads * kVecs) {"),
    ("      *o = a[u];\n    }\n  }\n}\n",
     "      *o = a[u];\n    }\n  }\n  }\n}\n"),
    ("  const int64_t blocks = by_vec > by_scalar ? by_vec : by_scalar;",
     "  int64_t blocks = by_vec > by_scalar ? by_vec : by_scalar;\n"
     "  int dev = 0, sms = 0, per_sm = 0;\n"
     "  cudaGetDevice(&dev);\n"
     "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
     "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n"
     "      &per_sm,\n"
     "      g_is_bf16 ? reinterpret_cast<const void*>(\n"
     "                      clip_accum_kernel<__nv_bfloat16, kFromZero>)\n"
     "                : reinterpret_cast<const void*>(\n"
     "                      clip_accum_kernel<float, kFromZero>),\n"
     "      kThreads, static_cast<size_t>(m) * sizeof(float));\n"
     "  if (blocks > int64_t{sms} * per_sm) blocks = int64_t{sms} * per_sm;"),
)


def tile(vecs: int, rows: int):
    return (("constexpr int kVecs = 2;", f"constexpr int kVecs = {vecs};"),
            ("constexpr int kRows = 4;", f"constexpr int kRows = {rows};"))


# name -> substitutions of the current source
VARIANTS = {
    "persistent": PERSISTENT,
    "evict_first": (("return __ldg(reinterpret_cast<const float4*>(p));",
                     "return __ldcs(reinterpret_cast<const float4*>(p));"),
                    ("const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));",
                     "const uint2 raw = __ldcs(reinterpret_cast<const uint2*>(p));")),
    "v1r4": tile(1, 4), "v4r4": tile(4, 4), "v2r2": tile(2, 2),
    "v4r2": tile(4, 2),
}


def variant_source(src: str, subs) -> str:
    """``src`` with each (old, new) of ``subs`` replaced once; raises if an
    anchor is missing, so a variant never silently equals the current
    source."""
    for old, new in subs:
        if src.count(old) != 1:
            raise ValueError(f"anchor found {src.count(old)} times: {old!r}")
        src = src.replace(old, new)
    return src


def build(sources: dict) -> dict:
    """name -> path of a .cu; one nvcc each, all started together; returns
    name -> loaded library."""
    from repro_torch.kernels import _build
    procs = {}
    for name, src in sources.items():
        lib = OUT_DIR / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, lib in libs.items():
        split = [] if name == "parent" else [I64, I64]
        for entry in (lib.clip_accum_inplace_launch, lib.clip_accum_launch):
            entry.argtypes = [P, P, I, P, P, ctypes.c_float, I, I64,
                              *split, P]
            entry.restype = I
    return libs


def launcher(lib, parent: bool):
    """The library's launch as the wrapper's ``_launch(entry, out, grads,
    norms, mask, clip_norm)``."""
    import torch
    from repro_torch.kernels import clip_accum as ca

    def launch(entry, out, grads, norms, mask, clip_norm):
        m, d = grads.shape
        split = [] if parent else list(ca.clip_split(
            out.data_ptr(), grads.data_ptr(), grads.element_size(), m, d)[:2])
        rc = getattr(lib, entry)(
            out.data_ptr(), grads.data_ptr(),
            int(grads.dtype == torch.bfloat16), norms.data_ptr(),
            mask.data_ptr(), float(clip_norm), m, d, *split,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{entry}: CUDA error {rc}")
    return launch


def kernel_ab(launches: dict) -> dict:
    """Every build at every shape: bitwise against the parent's, then timed
    in turns, with the bound and the yardsticks."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import clip_accum as ca
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(7)
    names = [n for n in launches if n != "parent"]
    order = ["parent", *names, *reversed(names), "parent"]
    res = {}
    for label, m, d in SHAPES:
        norms, mask = cs.clip_inputs(gen, m, device)
        g = torch.randn(m, d, generator=gen, device=device)
        acc = torch.randn(d, generator=gen, device=device)
        out = torch.empty(d, device=device)
        ref = torch.empty(d, device=device)
        r = {"bound_ms": {"inplace": cs.bound_ms((4.0 * m + 8) * d)[0],
                          "resident": cs.bound_ms((4.0 * m + 4) * d)[0]}}
        for entry, fresh in (("clip_accum_launch", None),
                             ("clip_accum_inplace_launch", acc)):
            if fresh is not None:
                ref.copy_(fresh)
            launches["parent"](entry, ref, g, norms, mask, 4.63)
            for n in names:
                if fresh is not None:
                    out.copy_(fresh)
                launches[n](entry, out, g, norms, mask, 4.63)
                if not cs.same_bits(out, ref):
                    raise AssertionError(f"{n} differs from the parent's at "
                                         f"{label} ({entry})")
        del ref
        torch.cuda.empty_cache()
        coef = ca.clip_coefs(norms, mask, 4.63)
        for form, entry, target in (
                ("resident", "clip_accum_launch", out),
                ("inplace", "clip_accum_inplace_launch", acc)):
            times = {}
            for n in order:
                times.setdefault(n, []).append(cs.cuda_ms(
                    lambda n=n: launches[n](entry, target, g, norms, mask,
                                            4.63), 10))
            lib = cs.clip_library_fns(
                g, coef, acc if form == "inplace" else None)
            for name, fn in lib.items():
                times[f"library_{name}"] = [cs.cuda_ms(fn, 10)]
                torch.cuda.empty_cache()
            r[form] = times
        res[label] = r
        print(label, json.dumps(r), flush=True)
        del g, acc, out
        torch.cuda.empty_cache()
    return res


def accumulate_ab(launches: dict) -> dict:
    """One accumulate per engine with the parent's kernels and with the
    current ones, in turns, per model of ACCUMULATE_MODELS (its cut and
    physical batch as chip_smoke.py trains it, no momentum)."""
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core import DPConfig
    from repro_torch.core.session import PrivacySession, TrainConfig
    from repro_torch.kernels import clip_accum as ca
    specs = {**cs.SSM_MODELS, **cs.MOE_MODELS, **cs.FRONTEND_MODELS}
    trains = {**{a: cs.SSM_TRAIN for a in cs.SSM_MODELS},
              **{a: cs.MOE_TRAIN for a in cs.MOE_MODELS},
              **{a: dict(cs.FRONTEND_TRAIN, seq_len=s["seq_len"])
                 for a, s in cs.FRONTEND_MODELS.items()}}
    engines, cs.ACCUMULATE_ENGINES = cs.ACCUMULATE_ENGINES, ACCUMULATE_ENGINES
    current = ca._launch
    res = {}
    try:
        for arch in ACCUMULATE_MODELS:
            spec = specs[arch]
            t0 = time.perf_counter()
            over = {k: spec[k] for k in ("n_layers", "cross_every")
                    if k in spec}
            cfg = dataclasses.replace(get_config(arch), **over)
            session = PrivacySession.from_config(
                cfg, DPConfig(engine="masked_pe", clip_norm=4.63),
                TrainConfig(**dict(trains[arch], steps=1, momentum=0.0,
                                   physical_batch=spec["physical_batch"])),
                device=torch.device("cuda"))
            if spec.get("prepare"):
                spec["prepare"](session)
            runs = []
            for kernel in ("parent", "current", "current", "parent"):
                ca._launch = launches["parent"] if kernel == "parent" \
                    else current
                gc.collect()
                torch.cuda.empty_cache()
                acc = cs.time_accumulate(session, iters=5)
                runs.append({"kernel": kernel, **{
                    e: {k: v[k] for k in ("ms", "min_ms", "all_ms")}
                    for e, v in acc.items()}})
                print(arch, kernel, json.dumps(
                    {e: v["min_ms"] for e, v in acc.items()}), flush=True)
            res[arch] = {"runs": runs, "seconds": time.perf_counter() - t0}
            del session
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        ca._launch = current
        cs.ACCUMULATE_ENGINES = engines
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="an earlier csrc/clip_accum.cu (the interface "
                         "before the split)")
    ap.add_argument("--accumulate", action="store_true",
                    help="also time one accumulate per engine with each")
    args = ap.parse_args()
    # the VLM cut's per-example engines sit at the memory edge: the same
    # allocator setting for both kernels keeps fragmentation out of the A/B
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("clip_ab: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    current = (_build.CSRC / "clip_accum.cu").read_text()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    sources = {"parent": Path(args.parent).resolve(),
               "current": _build.CSRC / "clip_accum.cu"}
    for name, subs in VARIANTS.items():
        path = OUT_DIR / f"clip_accum_{name}.cu"
        path.write_text(variant_source(current, subs))
        sources[name] = path
    record = {"nvidia_smi": cs.nvidia_smi_line(),
              "device": torch.cuda.get_device_name(0)}
    print(record["nvidia_smi"], flush=True)
    libs = build(sources)
    _build.build_all()
    launches = {n: launcher(lib, n == "parent") for n, lib in libs.items()}
    record["kernels"] = kernel_ab(launches)
    if args.accumulate:
        record["accumulate"] = accumulate_ab(launches)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "clip_ab.json").write_text(json.dumps(record, indent=1))
    print("clip_ab done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
