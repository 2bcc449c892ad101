"""K2's one-launch design (``csrc/md_viterbi.cu``) on the CPU: a torch
mirror of its one-warp carry (lane l holds slots l, l + 32, ...; dp[l-1]
is lane l-1's value of the same slot, and lane 31's value of the slot
before for lane 0) bit-equal to the plain lattice ``md_viterbi_lattice_ref``
for L on both sides of each 32-slot edge, and the launch plan: the slots,
the emissions' ring and the shape rule that keeps the int8 choices in
shared memory for the backtrace or reads them back from global memory,
against the constants of the source. The kernel runs on the card
(``chip_smoke.py``, every case bit-exact)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mlvae_tpu_torch import _build
from mlvae_tpu_torch.ops import decode as dec

torch.set_num_threads(2)

SRC = Path(_build.CSRC) / "md_viterbi.cu"
WARP = 32


def lattice_lanes(log_p_yx, log_p_y, y, log_p_b, lpi_w, t_lens, l_lens):
    """The kernel's lattice with the carry laid out as it holds it: (B,
    slots, 32 lanes, 2), slot j of lane i standing for phoneme 32 j + i.
    Returns (paths (T, B, L, 2), beta0 (B,)) as the plain lattice does."""
    B, T, N, _ = log_p_yx.shape
    L = y.shape[1]
    J = -(-L // WARP)
    e = dec._emissions(log_p_yx, log_p_y, y)                  # (B, T, L, 2)
    e = torch.cat([e, torch.zeros((B, T, J * WARP - L, 2))], 2).reshape(
        B, T, J, WARP, 2)
    slot = (torch.arange(J)[:, None] * WARP + torch.arange(WARP)[None, :])
    dp = torch.full((B, J, WARP, 2), dec.NEG_INF)
    dp[:, 0, 0] = lpi_w[:, 0] + e[:, 0, 0, 0]
    paths = torch.zeros((T, B, J, WARP, 2), dtype=torch.int64)
    for t in range(1, T):
        up = torch.roll(dp, 1, dims=2)          # __shfl_up_sync by one lane
        top = dp[:, :, WARP - 1]                # __shfl_sync from lane 31
        first = torch.cat([torch.full((B, 1, 2), dec.NEG_INF), top[:, :-1]],
                          1)
        prev = torch.cat([first[:, :, None], up[:, :, 1:]], 2)
        e_t = e[:, t]
        lpb = log_p_b[:, t, None, None]
        hold = (dp + lpb[..., 0:1]) + e_t
        sw = (lpb[..., 1:2] + lpi_w[:, t, None, None, :]) + e_t
        fc = prev[..., 0:1] + sw
        fi = prev[..., 1:2] + sw
        new = torch.maximum(hold, torch.maximum(fc, fi))
        path = torch.where((hold >= fc) & (hold >= fi), 0,
                           torch.where(fc >= fi, 1, 2))
        live = (t < t_lens)[:, None, None, None] & (slot < L)[None, ..., None]
        dp = torch.where(live, new, dp)
        paths[t] = torch.where(live, path, 0)
    last = l_lens.long() - 1
    ends = dp[torch.arange(B), last // WARP, last % WARP]
    return (paths.reshape(T, B, J * WARP, 2)[:, :, :L],
            torch.where(ends[:, 0] > ends[:, 1], 0, 1))


def _problem(rs, B, T, N, L, quantize):
    l_lens = rs.randint(1, L + 1, B)
    t_lens = np.array([rs.randint(l, T + 1) for l in l_lens])
    t_lens[0], l_lens[0] = T, L
    p = rs.rand(B, T, N) * 0.98 + 0.01
    bv = rs.rand(B, T) * 0.98 + 0.01
    logits = rs.randn(B, T, 2)
    if quantize:
        p, bv, logits = np.round(p * 4) / 4, np.round(bv * 4) / 4, \
            np.round(logits)
    prior = rs.dirichlet(np.ones(N))
    lpi = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    f32 = [torch.from_numpy(np.asarray(a, np.float32)) for a in (
        dec.clamped_log_np(np.stack([p, 1 - p], 3)),
        dec.clamped_log_np(np.stack([prior, 1 - prior], 1)))]
    return (*f32, torch.from_numpy(rs.randint(0, N, (B, L))),
            torch.from_numpy(dec.clamped_log_np(
                np.stack([bv, 1 - bv], 2)).astype(np.float32)),
            torch.from_numpy(lpi.astype(np.float32)),
            torch.from_numpy(t_lens), torch.from_numpy(l_lens))


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("L", [1, 8, 32, 33, 40, 64])
def test_lane_carry_is_the_plain_lattice(L, quantize):
    """Bit for bit, ties included (quantized inputs), with ragged lengths
    and a weight of 0.5 folded into log pi."""
    rs = np.random.RandomState(L * 10 + quantize)
    yx, y_, y, lpb, lpi, tl, ll = _problem(rs, 5, max(L + 6, 12), 9, L,
                                           quantize)
    lpi_w = dec.fold_weight(lpi, 0.5)
    want = dec.md_viterbi_lattice_ref(yx, y_, y, lpb, lpi_w, tl, ll)
    got = lattice_lanes(yx, y_, y, lpb, lpi_w, tl, ll)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("T,L,slots,chunk,choices", [
    (160, 8, 1, 32, "shared"), (160, 1, 1, 32, "shared"),
    (1, 1, 1, 32, "shared"), (160, 40, 2, 32, "shared"),
    (160, 64, 2, 31, "shared"), (512, 64, 2, 31, "shared"),
    (513, 64, 2, 31, "global"), (2000, 40, 2, 32, "global"),
    (160, 100, 4, 20, "shared"), (160, 512, 16, 3, "global"),
    (64, 512, 16, 3, "shared")])
def test_plan_keeps_the_choices_where_they_fit(T, L, slots, chunk, choices):
    """The choices stay in shared memory while T * L * 2 bytes fit in
    64 KB (T=512, L=64 is the last T at L=64), else the backtrace reads
    them back from global memory; a half of the ring holds up to 32
    steps of 2 L + 4 floats in 16 KB."""
    plan = dec.viterbi_plan(T, L)
    assert (plan["slots"], plan["chunk"], plan["choices"]) == (
        slots, chunk, choices)
    assert plan["slots"] // 2 * WARP < L <= plan["slots"] * WARP
    ring = 2 * chunk * (2 * L + 4) * 4
    assert ring <= 2 * dec.RING_FLOATS * 4
    kept = -(-2 * T * L // 16) * 16 if choices == "shared" else 0
    bits = 2 * -(-T // 128) * 16
    assert plan["smem_bytes"] == ring + -(-L // 4) * 16 + bits + kept
    assert plan["smem_bytes"] <= 232_448


@pytest.mark.parametrize("T,L", [(1, 513), (160, 0), (0, 8)])
def test_plan_refuses_what_the_kernel_does_not_take(T, L):
    with pytest.raises(ValueError, match="K2 takes"):
        dec.viterbi_plan(T, L)


def test_plan_constants_and_entry_point_are_the_sources():
    src = SRC.read_text()

    def const(name):
        return int(eval(re.search(rf"constexpr int {name} = ([0-9 *]+);",
                                  src).group(1)))
    for name in ("MAX_L", "RING_FLOATS", "MAX_CHUNK", "CHOICE_BYTES"):
        assert const(name) == getattr(dec, name), name
    sig = re.search(r"int mlvae_md_viterbi\(([^)]*)\)", src).group(1)
    assert len(sig.split(",")) == len(dec.VITERBI.argtypes)
    assert "mlvae_md_viterbi_plan(int T, int L, int* out)" in src
    # one kernel a decode: the two earlier entry points are gone
    names = [k.name for k in _build.KERNELS if k.source == "md_viterbi"]
    assert names == ["md_viterbi"]
    assert "-fmad=false" in _build._flags("md_viterbi")
    assert "__syncthreads" not in re.sub(r"//.*", "", src)


def test_every_slot_count_the_plan_gives_has_a_build():
    """The builds are the plan's slot counts up to MAX_L, and no more: the
    16-slot build is the widest, the last whose carry stays in registers."""
    src = SRC.read_text()
    builds = {int(n) for n in re.findall(
        r"md_viterbi_kernel<(\d+), SHARED>", src)}
    slots = {dec.viterbi_plan(160, L)["slots"]
             for L in range(1, dec.MAX_L + 1)}
    assert builds == slots == {1, 2, 4, 8, 16}


def test_the_wrapper_refuses_cpu_inputs():
    rs = np.random.RandomState(0)
    prob = _problem(rs, 2, 6, 5, 3, False)
    with pytest.raises(ValueError, match="CUDA device"):
        dec.md_viterbi_batch_cuda(*prob)
