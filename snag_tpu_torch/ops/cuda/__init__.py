"""Hand-written Hopper kernels and their plain-PyTorch twins.

Each module here wraps one ``csrc/*.cu`` source.  Its wrappers launch the
kernel for CUDA tensors and use the twin only for CPU tensors; a kernel
that fails to build or launch raises.  Every kernel keeps a
``KernelStats`` with a launch count, and every twin a count of its CPU
dispatches.
"""


def all_stats():
    """{name: KernelStats} of every kernel of the package."""
    from snag_tpu_torch.ops.cuda import (gat_attention, gat_bwd, ntxent,
                                         rank_eval, snag_loss, tile_segment)
    return {s.name: s for s in (gat_attention.STATS, gat_bwd.STATS,
                                ntxent.STATS_LSE, ntxent.STATS_GRAD,
                                rank_eval.STATS_TOPK, rank_eval.STATS_RANKS,
                                snag_loss.STATS_LSE, snag_loss.STATS_GRAD,
                                tile_segment.STATS,
                                *bf16_stats(), *wide_stats())}


def bf16_stats():
    """The launch counts of the bf16-operand entries (``--dtype
    bfloat16``), one per kernel that has one."""
    from snag_tpu_torch.ops.cuda import (gat_attention, gat_bwd, ntxent,
                                         snag_loss, tile_segment)
    return (gat_attention.STATS_BF16, gat_bwd.STATS_BF16,
            ntxent.STATS_LSE_BF16, ntxent.STATS_GRAD_BF16,
            snag_loss.STATS_LSE_BF16, snag_loss.STATS_GRAD_BF16,
            tile_segment.STATS_BF16)


def wide_stats():
    """The launch counts of the instantiations past the main path's
    shapes, counted apart from their kernel's: both GAT kernels' wide path
    (H > 4, or C past a warp's slices), sweep A's lists in shared memory
    (CSLS k > 10), and both f32 loss gradients' wide body (past the
    main-path body's accumulator)."""
    from snag_tpu_torch.ops.cuda import (gat_attention, gat_bwd, ntxent,
                                         rank_eval, snag_loss)
    return (gat_attention.STATS_WIDE, gat_attention.STATS_BF16_WIDE,
            gat_bwd.STATS_WIDE, gat_bwd.STATS_BF16_WIDE,
            rank_eval.STATS_TOPK_LONG, ntxent.STATS_GRAD_WIDE,
            snag_loss.STATS_GRAD_WIDE)


def reset_stats() -> None:
    for s in all_stats().values():
        s.launches = 0
        s.twin_calls = 0
