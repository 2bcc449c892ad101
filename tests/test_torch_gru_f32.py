"""K5 in f32 (``csrc/gru_fwd.cu``, ``csrc/gru_bwd.cu``, sharing
``csrc/gru_common.cuh``) on the CPU: ``ops.gru.k5_plan``'s f32 launch
(blocks, shared memory, TMA boxes) against the sources' constants and
formulas for every H the builds take; their timing builds (the defines
kept out of every normal build, the entry points one argument longer) and
the timeline tools' phases against the sources' marks; the tools' launches
of the timing builds on meta tensors; and ``chip_smoke.py``'s K5 yard
(plans and times in turns with cuDNN's layer, f32 and bf16) rehearsed on
the CPU at a small shape with the card's timers stubbed. The kernels
themselves run on the card (``chip_smoke.py``, ``chip_ab.py``)."""
import re
from pathlib import Path

import pytest
import torch

from mlvae_tpu_torch import _build
from mlvae_tpu_torch.ops import gru as G
from mlvae_tpu_torch.tools import bench_bwd_timeline as btl
from mlvae_tpu_torch.tools import bench_fwd_timeline as ftl

REPO = Path(__file__).resolve().parent.parent
CSRC = _build.CSRC
F32_H = range(16, 529, 16)     # every H the f32 builds take


def _text(name):
    return (CSRC / name).read_text()


def _const(fname, name):
    m = re.search(rf"constexpr (?:int|size_t) {name} = ([^;]+);",
                  _text(fname))
    return m.group(1).strip()


def _body(fname, fn):
    """The return expression of ``fn`` in ``fname``, spaces collapsed."""
    m = re.search(rf"\b{fn}\(int H\) \{{\s*(?://[^\n]*\n\s*)*return ([^;]+);",
                  _text(fname))
    return " ".join(m.group(1).split())


def _consts():
    c = {n: int(_const("gru_common.cuh", n))
         for n in ("UNITS", "GATES", "BT", "KSPLIT", "THREADS", "BOXC",
                   "WP")}
    c["ROWS"] = c["GATES"] * c["UNITS"]
    c["BOX"] = c["BT"] * c["BOXC"]
    assert _const("gru_common.cuh", "RP") == "BT + 8"
    c["RP"] = c["BT"] + 8
    return c


# ---------------------------------------------------------------------------
# the plan against the sources
# ---------------------------------------------------------------------------

def test_f32_constants_are_the_kernels():
    c = _consts()
    assert (c["UNITS"], c["GATES"], c["BT"], c["KSPLIT"], c["THREADS"]) == (
        G.F32_UNITS, 3, G.BT, 4, G.THREADS)
    assert c["BOXC"] == G.F32_BOXC and c["BOXC"] * 4 == 128  # the swizzle
    assert c["RP"] == G.F32_RP
    assert int(_const("gru_common.cuh", "SMEM_LIMIT")) == G.SMEM_LIMIT
    # every thread takes the product: (K slice, unit, 16 row groups)
    assert c["THREADS"] == c["KSPLIT"] * c["UNITS"] * (c["BT"] // 4)
    assert int(_const("gru_bwd.cu", "KPT")) * c["THREADS"] >= G.K5_MAX_H


def test_f32_shared_memory_formulas_are_the_sources():
    assert _body("gru_common.cuh", "common_floats") == (
        "(size_t)n_boxes(H) * BOX + (size_t)H * UNITS * WP + "
        "(size_t)KSPLIT * ROWS * RP")
    assert _body("gru_fwd.cu", "fwd_smem_bytes") == (
        "sizeof(float) * common_floats(H) + sizeof(uint64_t) * n_boxes(H)")
    assert _body("gru_bwd.cu", "bwd_smem_bytes") == (
        "sizeof(float) * (common_floats(H) + (size_t)BT * ROWS) + "
        "sizeof(uint64_t) * n_boxes(H)")
    assert _body("gru_common.cuh", "n_boxes") == "(H + BOXC - 1) / BOXC"


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("H", F32_H)
def test_f32_plan_is_the_sources_launch(H, direction):
    c = _consts()
    nb = -(-H // c["BOXC"])
    floats = (nb * c["BOX"] + H * c["UNITS"] * c["WP"]
              + c["KSPLIT"] * c["ROWS"] * c["RP"])
    if direction == "bwd":
        floats += c["BT"] * c["ROWS"]
    plan = G.k5_plan(direction, H, False)
    assert plan.build == "f32" and plan.rows == c["BT"]
    assert plan.blocks == H // c["UNITS"] <= G.SMS
    assert plan.threads == c["THREADS"]
    # the whole 64-row tile of h_{t-1}, one mbarrier a box: no ring
    assert plan.boxes == nb
    assert plan.smem_bytes == 4 * floats + 8 * nb <= G.SMEM_LIMIT


@pytest.mark.parametrize("H, fwd, bwd", [(512, 177792, 180864),
                                         (528, 187016, 190088),
                                         (208, 84536, 87608),
                                         (16, 23048, 26120)])
def test_f32_shared_memory(H, fwd, bwd):
    # as the C plans printed them on the card
    assert G.k5_plan("fwd", H, False).smem_bytes == fwd
    assert G.k5_plan("bwd", H, False).smem_bytes == bwd


# ---------------------------------------------------------------------------
# the timing builds and the tools' phases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool, src, define, arg", [
    (ftl, "gru_fwd", _build.FWD_TIMELINE_DEFINE, "FWD_TIMELINE_ARG"),
    (btl, "gru_bwd", _build.K1_BWD_TIMELINE_DEFINE, "TL_ARG"),
])
def test_f32_timing_builds_bind_their_entry_points(tool, src, define, arg):
    name = f"{src}_timeline"
    assert _build.VARIANTS[name] == (src, [define])
    kernel = tool.TIMED[src]
    normal = {"gru_fwd": G.GRU_FWD, "gru_bwd": G.GRU_BWD}[src]
    assert kernel not in _build.KERNELS and normal in _build.KERNELS
    assert (kernel.source, kernel.symbol) == (name, f"mlvae_{name}")
    assert len(kernel.argtypes) == len(normal.argtypes) + 1
    # the timeline comes in through the macro before the stream, empty in
    # the normal build
    text = _text(f"{src}.cu")
    sig = re.search(rf"int mlvae_{src}\(\n#endif\n([^)]*)\)", text).group(1)
    assert sig.count(",") + 1 == len(normal.argtypes)
    assert re.search(rf"reverse {arg}, cudaStream_t stream$", sig)
    header = _text("fwd_timeline.cuh" if src == "gru_fwd"
                   else "bwd_timeline.cuh")
    assert re.search(rf"#define {arg} , unsigned long long\* timeline",
                     header)
    assert re.search(rf"#else\n#define {arg}\n", header)


def test_f32_fwd_marks_are_the_tools_phases():
    enum = re.search(r"enum FwdPhase \{([^}]*)\}",
                     _text("fwd_timeline.cuh")).group(1)
    names = [n.strip().split(" = ")[0] for n in enum.split(",")]
    slots = {n[len("FWD_"):].lower(): 2 + i for i, n in enumerate(names)}
    assert slots == ftl.PHASES
    marks = set(re.findall(r"FWD_MARK\(FWD_(\w+)\)", _text("gru_fwd.cu")))
    assert {m.lower() for m in marks} == set(ftl.PHASES) - {"input"}
    assert "FWD_STORE(s, 0);" in _text("gru_fwd.cu")


def test_f32_bwd_marks_are_the_tools_phases():
    text = _text("gru_bwd.cu")
    marks = {m.lower() for m in re.findall(r"TL_MARK\(TL_(\w+)\)", text)}
    assert marks == set(btl.K1_PHASES) - {"barrier"}
    assert "TL_ARRIVED();" in text and "TL_WAITED();" in text
    assert text.count("TL_STORE(s);") == 4   # both schedules, both exits


@pytest.fixture
def timed(monkeypatch):
    """The tools' f32 timing builds replaced by recorders (no card here)."""
    calls = []
    for kernel in (ftl.TIMED["gru_fwd"], btl.TIMED["gru_bwd"]):
        monkeypatch.setattr(kernel, "_fn",
                            lambda *a, _n=kernel.name: calls.append((_n, a))
                            or 0)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    return calls


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


@pytest.mark.parametrize("T, B, H", [(160, 64, 512), (3, 70, 208)])
def test_tools_launch_the_f32_timing_builds(timed, T, B, H):
    (hs, hs32), tl = ftl.timed_gru((_meta(T, B, 3 * H), _meta(3 * H, H),
                                    _meta(3 * H)))
    assert hs32 is None and hs.shape == (T, B, H)
    assert tl.shape == (T, H // 4, ftl.SLOTS) and tl.dtype == torch.int64
    prob = (_meta(T, B, 3 * H), _meta(3 * H, H), _meta(3 * H),
            _meta(T, B, H), None, _meta(T, B, H))
    (dgx, dw, db), tl = btl.timed_gru(prob)
    assert (dgx.shape, dw.shape, db.shape) == ((T, B, 3 * H), (3 * H, H),
                                               (3 * H,))
    assert tl.shape == (T, H // 4, btl.K1_SLOTS)
    (fn, fa), (bn, ba) = timed
    assert (fn, len(fa)) == ("gru_fwd_timeline",
                             len(ftl.TIMED["gru_fwd"].argtypes))
    assert (bn, len(ba)) == ("gru_bwd_timeline",
                             len(btl.TIMED["gru_bwd"].argtypes))
    assert fa[5:9] == (T, B, H, 0) and ba[11:15] == (T, B, H, 0)


# ---------------------------------------------------------------------------
# chip_smoke.py's K5 yard, rehearsed on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def smoke(monkeypatch):
    """``chip_smoke`` with the card's timers stubbed: ``cuda_ms`` calls
    the function once and reports 1000 ms less the calls before it (each
    time apart, and a call with more work later, so a difference of two
    is positive), the profiler split sees no CUDA kernel, and the bf16
    dW_hh kernel (called directly) accepts its launch."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke as cs
    calls = []

    def cuda_ms(fn, iters, warmup=2):
        fn()
        calls.append(iters)
        return 1000.0 - len(calls)

    monkeypatch.setattr(cs, "cuda_ms", cuda_ms)
    monkeypatch.setattr(cs, "kernel_split", lambda fn, steps: (
        fn(), (0.0, 0.0, []))[1])
    monkeypatch.setattr(G.GRU_DW_BF16, "_fn", lambda *a: 0)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    return cs, calls


def test_chip_smoke_gru_yard_rehearsed_on_the_cpu(smoke):
    cs, calls = smoke
    names = ("gru_fwd", "gru_bwd", "gru_fwd_bf16", "gru_bwd_bf16",
             "gru_dw_bf16")
    errs = {n: 0.0 for n in names}
    counts = {n: {"launches": 3} for n in names}
    lines = []
    torch.manual_seed(0)
    rows = cs.time_gru(torch.device("cpu"), lines.append, errs, counts,
                       T=4, B=3, H=16, In=8, rounds=1)
    assert [r["name"] for r in rows] == list(names)
    keys = {"name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"}
    for r in rows:
        assert keys <= set(r), r["name"]
        assert r["route"] == "cuda" and (REPO / r["source"]).is_file()
    for r in rows[:4]:
        # in turns with cuDNN's layer of the same dtype: the medians of two
        # samples each
        assert r["spread"][0] < r["ms"] < r["spread"][1]
        assert r["library_ms"] > 0
        assert r["factor"] == pytest.approx(r["ms"] / r["library_ms"])
        assert r["us_a_step"] == pytest.approx(r["ms"] * 1e3 / 4)
        assert r["shape"] == "T=4 B=3 H=16 " + (
            "bf16" if r["name"].endswith("bf16") else "f32")
        assert r["replaces"].endswith(
            ":31" if r["name"].startswith("gru_fwd") else ":63")
    assert sum(ln.startswith("  cuDNN f32 GRU kernels") for ln in lines) == 1
    assert sum(ln.startswith("  cuDNN bf16 GRU kernels") for ln in lines) \
        == 1
    # the recurrence alone: the bf16 backward less its dW_hh kernel
    assert rows[3]["recurrence_ms"] == pytest.approx(
        rows[3]["ms"] - rows[4]["ms"])
    # the kernel and cuDNN in turns: kernel, cuDNN, cuDNN, kernel
    assert calls.count(10) >= 4 * 4
