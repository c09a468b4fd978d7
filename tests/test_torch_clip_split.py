"""How the clip kernels (``csrc/clip_accum.cu``) walk a call: the split
that ``kernels/clip_accum.py`` ``clip_split`` hands to the launch, and the
plain versions at the lengths and base phases that reach the split's scalar
head, tail and all-scalar path, against the reference.

The CUDA kernel runs only on the card (``chip_smoke.py``
``check_clip_edges`` holds it bitwise against its plain version on these
paths); here the split is checked by arithmetic and by a model of the
kernel's two loops, the scalar one (head, then tail) and the vector one.

Tolerances: bitwise — the plain versions and the reference fold strictly
left over the rows with one rounding per op, at any base and length.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.clip_accum import clip_accum as ref_clip_accum
from repro.kernels.clip_accum import clip_accum_inplace as ref_clip_inplace
from repro.kernels.ref import clip_accum_ref
from repro_torch.kernels import clip_accum as ca

VEC = ca.VEC
# lengths below, at and past a vector and a block's worth, a prime past a
# page, and one past int32 indexing (arithmetic only: nothing is allocated)
LENGTHS = [*range(10), 255, 256, 257, 4099, 2 ** 31 + 5]
BASE = 0x7F3A_1C00_0000        # a 4 KB-aligned device address
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def _vector_elements(out_addr, g_addr, isz, m, d):
    """Independently of clip_split: the most elements a split can take in
    vectors, over every head h < VEC that puts the output on 16 bytes and
    every row of g on VEC * isz bytes."""
    best = 0
    for h in range(min(VEC, d + 1)):
        if ((out_addr + 4 * h) % 16 == 0
                and all((g_addr + isz * (b * d + h)) % (VEC * isz) == 0
                        for b in range(m))):
            best = max(best, (d - h) // VEC * VEC)
    return best


def _walk(head, vectors, d):
    """The kernel's loops as a model: the scalar loop's index i over head
    and tail mapped to its element, then the vectors' elements."""
    vend = head + VEC * vectors
    scalar = [i if i < head else vend + (i - head)
              for i in range(head + d - vend)]
    return scalar, list(range(head, vend))


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_phase", [0, 1, 2, 3])
def test_split_covers_every_element_once_on_the_right_path(m, dtype,
                                                           out_phase):
    isz = ITEMSIZE[dtype]
    out_addr = BASE + 4 * out_phase
    for d in LENGTHS:
        for g_phase in range(4):
            g_addr = BASE + (1 << 33) + isz * g_phase
            head, vectors, tail = ca.clip_split(out_addr, g_addr, isz, m, d)
            case = (d, g_phase, head, vectors, tail)
            assert min(head, vectors, tail) >= 0, case
            assert head + VEC * vectors + tail == d, case
            assert VEC * vectors == _vector_elements(out_addr, g_addr, isz,
                                                     m, d), case
            if vectors:
                # every vector of the output and of every row aligned
                assert head < VEC and tail < VEC, case
                assert (out_addr + 4 * head) % 16 == 0, case
                assert (g_addr + isz * head) % (VEC * isz) == 0, case
                assert m == 1 or (isz * d) % (VEC * isz) == 0, case
            else:
                assert (head, tail) == (d, 0) or head < VEC, case
            if d < 2 ** 31:
                scalar, vec = _walk(head, vectors, d)
                assert sorted(scalar + vec) == list(range(d)), case
            else:   # the same cover by interval ends, past int32 indexing
                assert head + VEC * vectors <= d and tail == d - (
                    head + VEC * vectors), case


def test_split_of_a_flat_layout_is_all_vectors():
    """FlatGradView totals are multiples of 256 on 16-byte aligned buffers:
    every engine call takes the vector path with no scalar edge."""
    for isz in (4, 2):
        for m in (1, 2, 32):
            assert ca.clip_split(BASE, BASE + (1 << 32), isz, m,
                                 85_866_496) == (0, 85_866_496 // VEC, 0)


def test_split_at_named_cases():
    # rows of odd length drift out of phase with the output
    assert ca.clip_split(BASE, BASE, 4, 3, 1_000_003) == (1_000_003, 0, 0)
    # one row of odd length keeps its vectors and takes a scalar tail
    assert ca.clip_split(BASE, BASE, 4, 1, 1_000_003) == (0, 250_000, 3)
    # g one f32 element off the output's phase
    assert ca.clip_split(BASE, BASE + 4, 4, 1, 4096) == (4096, 0, 0)
    # both one element off: a head of 3, then vectors
    assert ca.clip_split(BASE + 4, BASE + 4, 4, 2, 4096) == (3, 1023, 1)
    # bf16 rows one element off an 8-byte boundary
    assert ca.clip_split(BASE, BASE + 2, 2, 1, 4096) == (4096, 0, 0)


def test_vector_width_agrees_with_the_kernel_source():
    src = (Path(ca.__file__).resolve().parent.parent / "csrc"
           / "clip_accum.cu").read_text()
    assert re.search(r"constexpr int kVec = (\d+);", src).group(1) == str(
        VEC)


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [0, 1])
def test_plain_versions_bitwise_at_odd_length_and_base(m, dtype, shift):
    """The plain versions on an odd length and on a base one element off
    16 bytes (a contiguous ``buf[1:]``), against the reference's kernels
    (interpret mode) and its plain fold."""
    rng = np.random.default_rng(100 * m + shift)
    d = 1027
    g = rng.standard_normal((m, d)).astype(np.float32)
    acc = rng.standard_normal(d).astype(np.float32)
    norms = (np.abs(rng.standard_normal(m)) * 3).astype(np.float32)
    norms[0] = 0.0                                 # the 1e-12 floor
    mask = (rng.random(m) > 0.3).astype(np.float32)
    mask[0] = 1.0
    tdt = getattr(torch, dtype)
    gbuf = torch.empty(shift + m * d, dtype=tdt)
    gbuf[shift:] = torch.from_numpy(g.reshape(-1)).to(tdt)
    gt = gbuf[shift:].view(m, d)
    abuf = torch.empty(shift + d)
    abuf[shift:] = torch.from_numpy(acc)
    at = abuf[shift:]
    assert gt.is_contiguous() and at.is_contiguous()
    tn, tm = torch.from_numpy(norms), torch.from_numpy(mask)
    gj = jnp.asarray(g, getattr(jnp, dtype))
    args = (gj, jnp.asarray(norms), jnp.asarray(mask), 1.3)

    got = ca.clip_accum(gt, tn, tm, 1.3)
    want = np.asarray(clip_accum_ref(*args)).view(np.int32)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want)
    np.testing.assert_array_equal(
        got.numpy().view(np.int32),
        np.asarray(ref_clip_accum(*args, interpret=True)).view(np.int32))

    ca.clip_accum_inplace(at, gt, tn, tm, 1.3)
    ref = np.asarray(ref_clip_inplace(jnp.asarray(acc), *args))
    np.testing.assert_array_equal(at.numpy().view(np.int32),
                                  ref.view(np.int32))
