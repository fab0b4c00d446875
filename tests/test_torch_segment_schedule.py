"""The weighted segment sum's launch plan, and the device-time timer.

``csrc/tile_segment.cu`` gives each CSR row to one warp (``WARPS`` rows a
block); lane l owns the slices chunk * 32 G + l + 32 g (g < G) of a column
chunk (gridDim.y) and up to ``MAX_HEADS`` heads (gridDim.z walks the head
groups; a last group of fewer heads is launched on its own).  Here that
indexing runs in numpy over ``launch_plan``'s plan and must cover every
(row, head, slice) of agg exactly once, and write every (row, head) of
rowsum once (chunk 0, lane 0).  The card checks that the built library
computes the same plan (``tests/test_torch_cuda.py``).

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

from snag_tpu_torch.ops.cuda import tile_segment as ts

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


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
