"""The weighted segment sum's launch plans, the bf16 kernel's schedule,
and the device-time timer.

``csrc/tile_segment.cu`` gives each CSR row to one warp (``WARPS`` rows a
block); lane l owns the slices chunk * 32 G + l + 32 g (g < G) of a column
chunk (gridDim.y) and up to ``MAX_HEADS`` heads (gridDim.z walks the head
groups; a last group of fewer heads is launched on its own).  Here that
indexing runs in numpy over ``launch_plan``'s plan and must cover every
(row, head, slice) of agg exactly once, and write every (row, head) of
rowsum once (chunk 0, lane 0).  The card checks that the built library
computes the same plan (``tests/test_torch_cuda.py``).

The bf16 kernel (``launch_plan(..., bf16=True)``) puts a row on 16 lanes
where its slices fit in 16 x ``MAX_GROUPS_BF16`` (two rows a warp, a half
of the last warp perhaps without one), else on 32; the same coverage is
required of it at C = 300, 30, 319, 64 and odd widths.  Its per-row
schedule is emulated in numpy step for step as the kernel runs it: both
halves of a warp run the longer row's trip count, each edge's column and
weight reach its row's lanes by a shuffle of width ``lanes``, and a half
loads and adds nothing for the edges its row lacks; under ``round_term`` each
product is one bf16 rounding of the exact product (``mul.rn.bf16x2``) and
the backward's d_x is the f32 sum rounded once to bf16.  On random CSR rows
(empty rows, hub rows past a chunk of 32 edges, zero weights, products
below fp32's normal range) it must give the parent kernel's chains bit for
bit: agg an fmaf chain (or an ``__fadd_rn`` chain of
``round_bf16(__fmul_rn(e, x))``) over the row's edges in CSR order from 0,
rowsum a sum in edge order from 0, d_x that agg cast to bf16.  fmaf is
emulated in f64 (a bf16 product is exact there), the same function on both
sides.

``chip_smoke.device_ms`` traces REPS calls in one profiler session, each
in a ``record_function`` span, and sums per call the device time of the
kernels named like the wrapper's inside the call's GPU annotation; here
it runs on stub profiler events: host events, GPU user annotations
(by the event's flag, or by a name that is also a host event's), copies,
memsets and kernels outside every span are left out, a call's matching
kernels are summed, and a call with no matching kernel, or fewer than
another call, raises.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

import torch

from snag_tpu_torch.data.graph import DeviceGraph
from snag_tpu_torch.ops.cuda import tile_segment as ts
from snag_tpu_torch.ops.cuda.snag_loss import round_bf16_once
from torch_port_common import single_thread

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

single_thread()
F32 = np.float32


def coverage(plan, n, c, h):
    """(agg hits (n, h, C / vec), rowsum hits (n, h)) of the kernel's
    indexing over ``plan``'s launches."""
    nv = c // plan.vec
    agg = np.zeros((n, h, nv), np.int64)
    rowsum = np.zeros((n, h), np.int64)
    launches = [(plan.full, ts.MAX_HEADS, 0)] if plan.full else []
    if plan.tail:      # blockIdx.z is 0; the head index is offset instead
        launches.append((1, plan.tail, plan.full * ts.MAX_HEADS))
    lane = np.arange(32)[:, None]
    g = np.arange(plan.groups)[None, :]
    for z_blocks, hb, off in launches:
        for bx in range(-(-n // ts.WARPS)):
            for warp in range(ts.WARPS):
                i = bx * ts.WARPS + warp
                if i >= n:
                    continue            # a tail warp returns
                for by in range(plan.chunks):
                    s = (by * 32 * plan.groups + lane + 32 * g).ravel()
                    s = s[s < nv]
                    for bz in range(z_blocks):
                        h0 = off + bz * ts.MAX_HEADS
                        np.add.at(agg, (i, slice(h0, h0 + hb), s), 1)
                        if by == 0:
                            rowsum[i, h0:h0 + hb] += 1
    return agg, rowsum


@pytest.mark.parametrize("h", [1, 2, 5])
@pytest.mark.parametrize("c", [30, 300, 319, 1200, 4096])
def test_launch_plan_covers_every_row_head_and_slice_once(c, h):
    n = 7                               # the last block of 4 rows part empty
    for vec in ((4, 1) if c % 4 == 0 else (1,)):
        plan = ts.launch_plan(c, h, vec)
        nv = c // vec
        assert plan.vec == vec
        assert 1 <= plan.groups <= ts.MAX_GROUPS
        assert plan.full * ts.MAX_HEADS + plan.tail == h
        assert 0 <= plan.tail < ts.MAX_HEADS
        # no chunk is empty, and the chunks reach the last slice
        assert (plan.chunks - 1) * 32 * plan.groups < nv
        assert plan.chunks * 32 * plan.groups >= nv
        agg, rowsum = coverage(plan, n, c, h)
        assert (agg == 1).all(), (c, h, vec, plan)
        assert (rowsum == 1).all(), (c, h, vec, plan)


def test_launch_plan_at_the_bench_width():
    """C = 300 on float4 slices: 75 slices, 3 a lane, one chunk, one head
    group (the GAT forward's layout at the same width)."""
    assert ts.launch_plan(300, 1, 4) == ts.LaunchPlan(4, 3, 1, 0, 1)
    # the widest of the block-per-row kernel before: 1,024 slices a row
    assert ts.launch_plan(4096, 1, 4) == ts.LaunchPlan(4, 4, 8, 0, 1)
    assert ts.launch_plan(1023, 8, 1) == ts.LaunchPlan(1, 4, 8, 2, 0)


def head_groups(plan):
    """(z blocks, heads a group, head offset) of each launch of ``plan``."""
    out = [(plan.full, ts.MAX_HEADS, 0)] if plan.full else []
    if plan.tail:      # blockIdx.z is 0; the head index is offset instead
        out.append((1, plan.tail, plan.full * ts.MAX_HEADS))
    return out


def bf16_coverage(plan, n, c, h):
    """``coverage`` of the bf16 kernel's indexing: warp w of block bx owns
    rows (bx WARPS + w) 32 / lanes + a, a < 32 / lanes, lane l of a row
    slices chunk * lanes * G + l + lanes g."""
    nv = c // plan.vec
    lanes = plan.lanes
    per_warp = 32 // lanes
    agg = np.zeros((n, h, nv), np.int64)
    rowsum = np.zeros((n, h), np.int64)
    rl = np.arange(lanes)[:, None]
    g = np.arange(plan.groups)[None, :]
    for z_blocks, hb, off in head_groups(plan):
        for bx in range(-(-n // (ts.WARPS * per_warp))):
            for warp in range(ts.WARPS):
                first = (bx * ts.WARPS + warp) * per_warp
                if first >= n:
                    continue            # a tail warp returns
                for i in range(first, min(first + per_warp, n)):
                    for by in range(plan.chunks):
                        s = (by * lanes * plan.groups + rl + lanes * g).ravel()
                        s = s[s < nv]
                        for bz in range(z_blocks):
                            h0 = off + bz * ts.MAX_HEADS
                            np.add.at(agg, (i, slice(h0, h0 + hb), s), 1)
                            if by == 0:
                                rowsum[i, h0:h0 + hb] += 1
    return agg, rowsum


BF16_WIDTHS = [300, 30, 319, 64, 1, 7, 33, 75, 81, 321, 1023, 1200, 4096]


@pytest.mark.parametrize("h", [1, 2, 5])
@pytest.mark.parametrize("c", BF16_WIDTHS)
def test_bf16_launch_plan_covers_every_row_head_and_slice_once(c, h):
    # the last block part empty; at odd n a warp with one row
    for n in (7, 9, 11, 37):
        for vec in ((4, 1) if c % 4 == 0 else (1,)):
            plan = ts.launch_plan(c, h, vec, bf16=True)
            nv = c // vec
            assert plan.vec == vec and plan.lanes in (16, 32)
            assert 1 <= plan.groups <= ts.MAX_GROUPS_BF16
            assert plan.full * ts.MAX_HEADS + plan.tail == h
            assert (plan.chunks - 1) * plan.lanes * plan.groups < nv
            assert plan.chunks * plan.lanes * plan.groups >= nv
            # a row on 16 lanes whenever its slices fit there
            assert (plan.lanes == 16) == (nv <= 16 * ts.MAX_GROUPS_BF16)
            agg, rowsum = bf16_coverage(plan, n, c, h)
            assert (agg == 1).all(), (c, h, vec, n, plan)
            assert (rowsum == 1).all(), (c, h, vec, n, plan)


def test_bf16_launch_plan_at_the_bench_width():
    """C = 300 in 8-byte slices: 75 slices on 16 lanes of 5 (80 slots),
    two lane groups a warp, one chunk; the f32 plan is the parent's."""
    assert ts.launch_plan(300, 1, 4, bf16=True) == ts.LaunchPlan(
        4, 5, 1, 0, 1, 16)
    assert ts.launch_plan(300, 1, 4) == ts.LaunchPlan(4, 3, 1, 0, 1, 32)
    # C = 319 in single bf16: 10 groups of 32 in two chunks of 5 (the f32
    # entry's: three of 4)
    assert ts.launch_plan(319, 2, 1, bf16=True) == ts.LaunchPlan(
        1, 5, 2, 0, 2, 32)
    assert ts.launch_plan(319, 2, 1) == ts.LaunchPlan(1, 4, 3, 0, 2, 32)


# ------------------------------------------------- the bf16 row schedule

def bf16(a):
    """f32 values rounded to bf16 (nearest, ties to even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(a, F32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def fmaf(e, v, acc):
    """fmaf(e, v, acc) of bf16 e and v: the product is exact in f64."""
    return (acc.astype(np.float64) + np.float64(e) * v).astype(F32)


def parent_chains(row_ptr, col, x, e, round_term):
    """The parent kernel's sums, row by row in CSR order from 0: agg
    (n, h, c) and rowsum (n, h)."""
    n, c = x.shape
    h = e.shape[1]
    agg = np.zeros((n, h, c), F32)
    rowsum = np.zeros((n, h), F32)
    for i in range(n):
        for k in range(row_ptr[i], row_ptr[i + 1]):
            v = x[col[k]]
            for q in range(h):
                if round_term:   # __fadd_rn(acc, round_bf16(__fmul_rn(e, v)))
                    agg[i, q] = agg[i, q] + bf16(F32(e[k, q]) * v)
                else:
                    agg[i, q] = fmaf(e[k, q], v, agg[i, q])
                rowsum[i, q] = rowsum[i, q] + F32(e[k, q])
    return agg, rowsum


def bf16_kernel(plan, row_ptr, col, x, e, round_term, out_bf16):
    """weighted_segment_sum_bf16_kernel's schedule over ``plan``'s
    launches, step for step: (out (n, h, c), rowsum (n, h) or None); a
    value no lane writes stays NaN."""
    n, c = x.shape
    h = e.shape[1]
    vec, lanes, groups = plan.vec, plan.lanes, plan.groups
    per_warp = 32 // lanes
    nv = c // vec
    out = np.full((n, h, c), np.nan, F32)
    rowsum = None if out_bf16 else np.full((n, h), np.nan, F32)
    rl = np.arange(lanes)[:, None]
    g = np.arange(groups)[None, :]
    for z_blocks, hb, off in head_groups(plan):
        for bz in range(z_blocks):
            h0 = off + bz * ts.MAX_HEADS
            for by in range(plan.chunks):
                s = by * lanes * groups + rl + lanes * g        # (lanes, G)
                on_s = s < nv
                cols = (np.minimum(s, nv - 1)[..., None] * vec
                        + np.arange(vec))                       # (lanes, G, vec)
                for first in range(0, n, per_warp):
                    rows = [first + a for a in range(per_warp)]
                    beg = [row_ptr[i] if i < n else 0 for i in rows]
                    length = [row_ptr[i + 1] - row_ptr[i] if i < n else 0
                              for i in rows]
                    most = max(length)     # every row's lanes run its count
                    acc = np.zeros((per_warp, hb) + cols.shape, F32)
                    rs = np.zeros((per_warp, hb), F32)
                    for base in range(0, most, lanes):
                        m = [ln - base for ln in length]
                        mk = min(lanes, most - base)
                        # lane l of a row: edge beg + base + l, or 0s
                        j_l = [[col[b + base + r] if r < mi else 0
                                for r in range(lanes)]
                               for b, mi in zip(beg, m)]
                        e_l = [[e[b + base + r, h0:h0 + hb] if r < mi
                                else np.zeros(hb, F32) for r in range(lanes)]
                               for b, mi in zip(beg, m)]
                        for k in range(mk):
                            for a in range(per_warp):
                                src = k % lanes         # shuffle width lanes
                                j, eb = j_l[a][src], e_l[a][src]
                                if k >= m[a]:
                                    continue    # no edge left: no load, add
                                v = np.where(on_s[..., None], x[j][cols],
                                             0).astype(F32)
                                for q in range(hb):
                                    if round_term:       # mul.rn.bf16x2
                                        term = round_bf16_once(
                                            torch.from_numpy(
                                                np.float64(eb[q]) * v)
                                        ).numpy()
                                        acc[a, q] = acc[a, q] + term
                                    else:
                                        acc[a, q] = fmaf(eb[q], v, acc[a, q])
                                    rs[a, q] = rs[a, q] + F32(eb[q])
                    for a, i in enumerate(rows):
                        if i >= n:
                            continue
                        for q in range(hb):
                            vals = acc[a, q]
                            if out_bf16:
                                vals = bf16(vals)
                            out[i, h0 + q, cols[on_s]] = vals[on_s]
                        if rowsum is not None and by == 0:
                            rowsum[i, h0:h0 + hb] = rs[a]
    return out, rowsum


def _random_rows(seed, n, c, h):
    """CSR rows of random lengths with empty rows and hub rows of 40 and
    70 edges; bf16 x with values below fp32's normal range, bf16 e with
    zero weights."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 14, size=n)
    lengths[rng.choice(n, 3, replace=False)] = 0
    lengths[1], lengths[n - 2] = 40, 70
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    col = rng.integers(n, size=row_ptr[-1])
    x = bf16(rng.normal(size=(n, c)).astype(F32))
    tiny = rng.random((n, c)) < 0.05
    x[tiny] = bf16((x[tiny] * 2.0 ** -120).astype(F32))
    e = bf16(rng.uniform(0.1, 2.0, size=(row_ptr[-1], h)).astype(F32))
    e[rng.random(e.shape) < 0.1] = 0.0
    e[rng.random(e.shape) < 0.05] *= F32(2.0 ** -20)
    return row_ptr, col, x, bf16(e)


def _bits(a):
    return np.ascontiguousarray(a, F32).view(np.int32)


@pytest.mark.parametrize("round_term", [False, True])
@pytest.mark.parametrize("c,h,vec,n", [(300, 1, 4, 23), (300, 1, 4, 19),
                                       (30, 1, 1, 23), (319, 2, 1, 23),
                                       (64, 3, 4, 19), (20, 5, 4, 23)])
def test_bf16_schedule_gives_the_parents_chains_bit_for_bit(c, h, vec, n,
                                                          round_term):
    """Odd n: the last warp's second row is missing."""
    row_ptr, col, x, e = _random_rows(c + h + n, n, c, h)
    plan = ts.launch_plan(c, h, vec, bf16=True)
    want_agg, want_rs = parent_chains(row_ptr, col, x, e, round_term)
    agg, rs = bf16_kernel(plan, row_ptr, col, x, e, round_term, False)
    assert np.array_equal(_bits(agg), _bits(want_agg))
    assert np.array_equal(_bits(rs), _bits(want_rs))
    # the products below fp32's normal range and the zero weights were there
    assert (np.abs(x) < 2.0 ** -100).sum() > 0 and (e == 0).sum() > 0
    if round_term:     # the backward's d_x: that agg rounded once to bf16
        d_x, none = bf16_kernel(plan, row_ptr, col, x, e, True, True)
        assert none is None
        assert np.array_equal(_bits(d_x), _bits(bf16(want_agg)))


@pytest.mark.parametrize("round_term", [False, True])
def test_bf16_twin_gives_the_schedules_sums(round_term):
    """The twin, which the CPU path runs, on the same rows: agg and rowsum
    within rtol = atol = 1e-5 of the emulated kernel (its f32 products of
    bf16 values round where fmaf does not, below fp32's normal range), and
    ``out_bf16`` its f32 sum rounded to bf16 with no rowsum."""
    n, c, h = 23, 300, 1
    row_ptr, col, x, e = _random_rows(5, n, c, h)
    lengths = np.diff(row_ptr)
    graph = DeviceGraph(
        n, len(col), torch.as_tensor(row_ptr, dtype=torch.int32),
        torch.as_tensor(np.repeat(np.arange(n), lengths)),
        torch.as_tensor(col, dtype=torch.int32),
        torch.ones(len(col)), None)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    et = torch.from_numpy(e).to(torch.bfloat16)
    agg, rs = ts.weighted_segment_sum(xt, et, graph, round_term=round_term)
    want_agg, want_rs = bf16_kernel(ts.launch_plan(c, h, 4, bf16=True),
                                    row_ptr, col, x, e, round_term, False)
    np.testing.assert_allclose(agg.numpy(), want_agg, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rs.numpy(), want_rs, rtol=1e-5, atol=1e-5)
    if round_term:
        d_x, none = ts.weighted_segment_sum(xt, et, graph, round_term=True,
                                            out_bf16=True)
        assert none is None and d_x.dtype == torch.bfloat16
        assert torch.equal(d_x, agg.to(torch.bfloat16))
    else:
        with pytest.raises(ValueError, match="out_bf16"):
            ts.weighted_segment_sum(xt, et, graph, out_bf16=True)


def _ev(name, start, ms, device=DeviceType.CUDA, **flags):
    return SimpleNamespace(
        name=name, device_type=device, device_time=1e3 * ms,
        time_range=SimpleNamespace(start=start, end=start + 1e3 * ms),
        **flags)


KERNEL = "void (anonymous namespace)::weighted_segment_sum_kernel<1, 4, 3>"


def _trace(per_call, extra=()):
    """Events of traced calls: call r's host span over [1000 r, 1000 r +
    900) us and its GPU annotation over [1000 r + 10, 1000 r + 810), its
    kernels of ``per_call[r]`` ms each, other work, a copy and a memset;
    then an uncounted kernel after the last span."""
    events = []
    for r, kernel_ms in enumerate(per_call):
        t0 = 1000.0 * r
        events.append(_ev(f"{cs.CALL}{r}", t0, 0.9, DeviceType.CPU))
        events.append(_ev(f"{cs.CALL}{r}", t0 + 10, 0.8,
                          is_user_annotation=True))
        events += [_ev("aten::empty", t0, 0.0, DeviceType.CPU),
                   _ev("Optimizer.step#AdamW.step", t0, 0.0, DeviceType.CPU)]
        for k, ms in enumerate(kernel_ms):
            events.append(_ev(f"{KERNEL}(float const*)", t0 + 20 + 100 * k,
                              ms))
        events += [_ev("void at::native::elementwise_kernel<128, 2>", t0 + 500,
                       0.09),
                   _ev("Memcpy HtoD (Pageable -> Device)", t0 + 600, 0.09),
                   _ev("Memset (Device)", t0 + 700, 0.09)]
    events.append(_ev(f"{KERNEL}(float const*)", 1000.0 * len(per_call), 7.0))
    return events + list(extra)


NAMES = cs.DEVICE_KERNELS["weighted_segment_sum"]


def test_call_kernel_ms_sums_each_calls_named_kernels():
    got = cs.call_kernel_ms(_trace([[0.05, 0.01], [0.05, 0.02]]), NAMES, 2)
    assert got == pytest.approx([0.06, 0.07])
    # GPU user annotations named like the kernels: by the event's flag, or,
    # where torch has no flag, by a name that is also a host event's
    flagged = _ev("weighted_segment_sum span", 30, 0.3,
                  is_user_annotation=True)
    span = "weighted_segment_sum#call"
    by_name = [_ev(span, 30, 0.3), _ev(span, 30, 0.0, DeviceType.CPU)]
    got = cs.call_kernel_ms(_trace([[0.05]], [flagged, *by_name]), NAMES, 1)
    assert got == pytest.approx([0.05])
    host = cs.host_names(_trace([[]]))
    assert not cs.is_kernel(_ev("Optimizer.step#AdamW.step", 0, 0.7), host)
    assert cs.is_kernel(_ev("Optimizer.step#AdamW.step", 0, 0.7))
    assert not cs.is_kernel(_ev("Memset (Device)", 0, 0.1))
    # a call without the named kernel, or with fewer than another, raises
    with pytest.raises(RuntimeError, match="no kernel"):
        cs.call_kernel_ms(_trace([[0.05], []]), NAMES, 2)
    with pytest.raises(RuntimeError, match="no kernel"):
        cs.call_kernel_ms(_trace([[0.05, 0.02], [0.05]]), NAMES, 2)
    with pytest.raises(RuntimeError, match="no kernel"):
        cs.call_kernel_ms(_trace([[0.05]]), cs.DEVICE_KERNELS["gat_bwd"], 1)
    # a call whose GPU annotation is missing
    no_span = [ev for ev in _trace([[0.05], [0.05]])
               if not (ev.name == f"{cs.CALL}1"
                       and ev.device_type == DeviceType.CUDA)]
    with pytest.raises(RuntimeError, match="no kernel"):
        cs.call_kernel_ms(no_span, NAMES, 2)


def test_device_ms_traces_a_lost_session_again():
    """A session whose counted calls left no span on the card is traced
    again, up to ``sessions`` sessions; a session that lost only some
    calls' kernels still raises at once."""
    traced = []
    results = [_trace([[0.05]] * cs.REPS)]
    lost = [ev for ev in _trace([[0.05]] * cs.REPS)
            if ev.device_type != DeviceType.CUDA]

    def trace(fn, calls):
        traced.append(calls)
        return (results if len(traced) == 3 else [lost])[0]
    assert cs.device_ms(lambda: None, NAMES, trace=trace) == \
        pytest.approx(0.05)
    assert traced == [cs.REPS] * 3
    traced.clear()
    with pytest.raises(cs.LostSession):
        cs.device_ms(lambda: None, NAMES, trace=trace, sessions=2)
    assert traced == [cs.REPS] * 2
    partial = _trace([[0.05]] * (cs.REPS - 1) + [[]])
    traced.clear()
    with pytest.raises(RuntimeError, match="no kernel") as err:
        cs.device_ms(lambda: None, NAMES,
                     trace=lambda fn, calls: traced.append(calls) or partial)
    assert not isinstance(err.value, cs.LostSession) and len(traced) == 1


def test_device_ms_retries_a_partial_session_only_when_asked():
    """A session that kept the spans of some counted calls but not all
    raises ``PartialSession`` (not a ``LostSession``): traced again when
    ``retry`` names it, as the default ``PROFILER_LOSSES`` does, and raised
    at once when it does not; a session whose calls all kept their spans
    but not their kernels is no partial session, and raises at once."""
    full = _trace([[0.05]] * cs.REPS)
    partial = [ev for ev in full if not (
        ev.name == f"{cs.CALL}0" and ev.device_type == DeviceType.CUDA)]
    traced = []

    def trace(fn, calls):
        traced.append(calls)
        return full if len(traced) == 2 else partial
    assert cs.PROFILER_LOSSES == (cs.LostSession, cs.PartialSession)
    with pytest.raises(cs.PartialSession) as err:
        cs.device_ms(lambda: None, NAMES, trace=trace,
                     retry=(cs.LostSession,))
    assert not isinstance(err.value, cs.LostSession) and traced == [cs.REPS]
    traced.clear()
    assert cs.device_ms(lambda: None, NAMES, trace=trace) == \
        pytest.approx(0.05)
    assert traced == [cs.REPS] * 2
    traced.clear()
    assert cs.device_ms(lambda: None, NAMES, trace=trace,
                        retry=(cs.LostSession, cs.PartialSession)) == \
        pytest.approx(0.05)
    assert traced == [cs.REPS] * 2
    traced.clear()
    with pytest.raises(cs.PartialSession):
        cs.device_ms(lambda: None, NAMES, trace=lambda fn, calls:
                     traced.append(calls) or partial)
    assert traced == [cs.REPS] * 4
    with pytest.raises(cs.PartialSession):
        cs.device_ms(lambda: None, NAMES, trace=lambda fn, calls: partial,
                     retry=(cs.PartialSession,), sessions=2)
    no_kernel = _trace([[0.05]] * (cs.REPS - 1) + [[]])
    traced.clear()
    with pytest.raises(RuntimeError, match="no kernel") as err:
        cs.device_ms(lambda: None, NAMES, trace=lambda fn, calls:
                     traced.append(calls) or no_kernel)
    assert not isinstance(err.value, (cs.LostSession, cs.PartialSession))
    assert traced == [cs.REPS]


def test_a_session_that_lost_its_start_into_the_first_call_is_partial():
    """A session whose record on the card begins inside its first counted
    call, which alone holds fewer kernels than the others, lost its start
    (the settling calls' kernels and that call's first): ``PartialSession``,
    traced again.  The same shortfall after a recorded settling call's
    kernel, or in a later call, is the kernel's and raises at once."""
    lost = _trace([[0.01]] + [[0.05, 0.01]] * (cs.REPS - 1))
    with pytest.raises(cs.PartialSession, match="no kernel"):
        cs.call_kernel_ms(lost, NAMES, cs.REPS)
    traced = []
    full = _trace([[0.05, 0.01]] * cs.REPS)
    assert cs.device_ms(lambda: None, NAMES, trace=lambda fn, calls: (
        traced.append(calls) or (full if len(traced) == 2 else lost))) == \
        pytest.approx(0.06)
    assert traced == [cs.REPS] * 2
    settled = [_ev(f"{KERNEL}(float const*)", -500.0, 0.05)] + lost
    later = _trace([[0.05, 0.01]] + [[0.01]] + [[0.05, 0.01]] * (cs.REPS - 2))
    for events in (settled, later):
        with pytest.raises(RuntimeError, match="no kernel") as err:
            cs.call_kernel_ms(events, NAMES, cs.REPS)
        assert not isinstance(err.value, (cs.LostSession, cs.PartialSession))


def test_device_ms_is_the_median_of_the_per_call_sums():
    per_call = [[0.04, 0.01], [0.03, 0.0], [0.08, 0.02], [0.06, 0.0],
                [0.05, 0.0]]
    traced = []

    def trace(fn, calls):
        fn()
        traced.append(calls)
        return _trace(per_call)
    got = cs.device_ms(lambda: None, NAMES, trace=trace)
    assert traced == [cs.REPS]
    # per call 0.05, 0.03, 0.10, 0.06, 0.05
    assert got == pytest.approx(0.05)
