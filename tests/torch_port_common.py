"""Shared set-up of the ``test_torch_*`` files: one small SNAG geometry,
built as a JAX-package config and as a port config from the same fields
(``model_name`` switches the family), the same model in both packages with
its weights carried across, and the JAX package's Pallas paths in
interpret mode."""

import contextlib
import unittest.mock as mock

import torch

SMALL = dict(
    data_choice="SYNTH", model_name="SNAG", hidden_units="32,32,32",
    heads="2,2", attr_dim=32, img_dim=32, name_dim=32, char_dim=32,
    hidden_size=32, intermediate_size=64, num_attention_heads=2,
    num_hidden_layers=1, structure_encoder="gat", use_surface=0,
    inner_view_num=4, random_seed=7, synth_ents=200, synth_rels=10,
    synth_triples=700, synth_img_dim=24, exp_name="torchport", csls=True,
    csls_k=3, no_tensorboard=True, add_noise=0)


def configs(data_root: str, **overrides):
    """(JAX-package Config, port Config) for the same fields."""
    from snag_tpu.config import Config as JaxConfig
    from snag_tpu.config import finalize_config as jax_finalize
    from snag_tpu_torch.config import Config as TorchConfig
    from snag_tpu_torch.config import finalize_config as torch_finalize
    kw = {**SMALL, **overrides}
    return (jax_finalize(JaxConfig(**kw), data_root=data_root),
            torch_finalize(TorchConfig(device="cpu", **kw),
                           data_root=data_root))


# the Kendall layers each family's training loss adds to its joint_emb tree
KENDALL_LAYERS = {"SNAG": ("multi_loss_layer",), "EVA": (),
                  "MCLEA": ("multi_loss_layer", "align_multi_loss_layer"),
                  "MEAformer": ("multi_loss_layer",)}


def jax_params(model, feats, graph, key):
    """The JAX package's param tree of ``model`` (any ported family) for
    an inference run: the tree of a jitted init of ``joint_emb`` plus the
    Kendall layers' zero log-variances.  That is the tree
    ``create_train_state`` builds (without ``--awloss``), made without
    tracing the training loss."""
    import jax
    import jax.numpy as jnp
    params = jax.jit(lambda k: model.init(
        {"params": k}, feats, graph, method=type(model).joint_emb))(key)
    return {**params["params"],
            **{name: {"log_vars": jnp.zeros((6,))}
               for name in KENDALL_LAYERS[model.cfg.model_name]}}


def fast_create_train_state(cfg, model, feats, graph, tx, seed,
                            extra_init_kwargs=None):
    """Drop-in for ``snag_tpu.train.step.create_train_state`` with the
    same key split, built on ``jax_params``."""
    import jax
    import jax.numpy as jnp
    from snag_tpu.train.step import TrainState
    init_rng, _, base_key = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = jax_params(model, feats, graph, init_rng)
    return TrainState(params=params, opt_state=tx.init(params),
                      step=jnp.zeros((), jnp.int32), base_key=base_key)


def assert_graph_equal(jg, tg):
    """The port's compact ``Graph`` holds the real edges of the JAX
    package's padded one, in the same order, with the same CSR rows."""
    import numpy as np
    m = jg.mask
    assert tg.n_nodes == jg.n_nodes and tg.n_edges == jg.n_edges
    np.testing.assert_array_equal(tg.row, jg.row[m])
    np.testing.assert_array_equal(tg.col, jg.col[m])
    np.testing.assert_array_equal(tg.w, jg.w[m])
    assert tg.mask.all() and tg.mask.shape == (tg.n_edges,)
    np.testing.assert_array_equal(tg.row_ptr[:-1], jg.starts)
    np.testing.assert_array_equal(np.diff(tg.row_ptr), jg.deg)
    assert tg.row_ptr[-1] == tg.n_edges


def bf16_np(a):
    """numpy f32 values rounded to bf16 (as f32): the one input both
    packages take."""
    return torch.from_numpy(a).to(torch.bfloat16).to(torch.float32).numpy()


def assert_close_bf16(got, want, name, tol=4e-3):
    """max |err| <= tol x max |want| (a JAX array or numpy), every value
    finite; the default is about one bf16 ulp of the output's scale."""
    import jax.numpy as jnp
    import numpy as np
    got = np.asarray(torch.as_tensor(got).detach().to(torch.float32))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, name
    assert np.isfinite(got).all(), name
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"{name}: max|err| {err} > {tol} x {scale}"


def single_thread():
    # tier-1 runs several xdist workers; one intra-op thread each
    torch.set_num_threads(1)


def model_pair(data_root: str, **overrides):
    """The same small model (SNAG unless ``model_name`` says otherwise) in
    both packages, weights carried across.

    Returns a dict with the JAX side (``jcfg``, ``jmodel``, ``jdata``,
    ``jfeats``, ``params`` as numpy) and the port side (``tcfg``,
    ``tmodel`` on the CPU holding ``params``, ``tdata``, ``tfeats``,
    ``tgraph``).  The Kendall log-variances are set away from zero so
    that they weigh the loss terms."""
    import jax
    import numpy as np
    from snag_tpu.data.dataset import load_data as jax_load_data
    from snag_tpu.models import build_model as jax_build_model
    from snag_tpu.models.encoder import prepare_features as jax_features
    from snag_tpu_torch.data.dataset import load_data
    from snag_tpu_torch.models import build_model
    from snag_tpu_torch.models.encoder import place_features
    from snag_tpu_torch.utils.import_reference import state_dict_from_flax

    jcfg, tcfg = configs(data_root, **overrides)
    jdata = jax_load_data(jcfg)
    jmodel = jax_build_model(jcfg, jdata)
    jfeats = jax_features(jcfg, jdata)
    params = jax.device_get(jax_params(
        jmodel, jfeats, jdata.graph, jax.random.PRNGKey(jcfg.random_seed)))
    for i, name in enumerate(KENDALL_LAYERS[jcfg.model_name]):
        params[name]["log_vars"] = np.linspace(
            -0.3 + 0.1 * i, 0.4 - 0.2 * i, 6).astype(np.float32)
    tdata = load_data(tcfg)
    tmodel = build_model(tcfg, tdata, torch.Generator().manual_seed(0))
    tmodel.load_state_dict(state_dict_from_flax(params), strict=True)
    return dict(jcfg=jcfg, jmodel=jmodel, jdata=jdata, jfeats=jfeats,
                params=params, tcfg=tcfg, tmodel=tmodel, tdata=tdata,
                tfeats=place_features(tcfg, tdata, "cpu")[0],
                tgraph=tdata.graph.to_torch("cpu"))


def padded_batch(train_ill, b: int, n_valid: int):
    """The first ``n_valid`` train pairs padded to ``b`` rows, the runner's
    way: (links (b, 2) int64, valid (b,) bool) as numpy."""
    import numpy as np
    links = np.zeros((b, 2), dtype=np.int64)
    links[:n_valid] = train_ill[:n_valid]
    return links, np.arange(b) < n_valid


def small_argv(data_path, **extra):
    """``train_mmea`` arguments for the ``SMALL`` geometry on the CPU;
    ``extra`` adds or overrides flags (a value of "" passes the bare flag)."""
    argv = ["--device", "cpu", "--data_path", str(data_path), "--csls",
            "--no_tensorboard"]
    for k, v in {**SMALL, **extra}.items():
        if k in ("csls", "no_tensorboard"):
            continue
        argv += [f"--{k}"] + ([] if v == "" else [str(v)])
    return argv


@contextlib.contextmanager
def pallas_interpret(flat=None):
    """The JAX package's Pallas paths forced on, in interpret mode; the
    mixture kernels on 8-row tiles, so that small batches stay small."""
    from jax.experimental import pallas as pl
    import snag_tpu.ops.gat_attn_primitive as gp
    import snag_tpu.ops.pallas.gat_attention as ga_jax
    import snag_tpu.ops.pallas.ntxent_kernel as nk
    import snag_tpu.ops.pallas.snag_loss_kernel as sk
    import snag_tpu.ops.pallas.tile_segment as tsg
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)
    with contextlib.ExitStack() as stack:
        for target, name, value in (
                (pl, "pallas_call", interp),
                (gp, "pallas_available", lambda: True),
                (ga_jax, "pallas_available", lambda: True),
                (nk, "FORCE_INTERPRET", True), (sk, "FORCE_INTERPRET", True),
                (sk, "RT_F", 8), (sk, "RT_B", 8)):
            stack.enter_context(mock.patch.object(target, name, value))
        if flat is not None:
            stack.enter_context(mock.patch.object(tsg, "FLAT_GRID", flat))
        yield


@contextlib.contextmanager
def f32_reductions():
    """JAX's bf16 ``reduce_sum`` lowered as an f32 sum rounded once to
    bf16 (XLA's CPU backend adds bf16 reductions in bf16, see
    ``test_torch_bf16.py``); other dtypes unchanged."""
    import jax.numpy as jnp
    from jax._src.interpreters import mlir
    from jax._src.lax import lax as lax_internal
    orig = mlir._lowerings[lax_internal.reduce_sum_p]

    def lower(ctx, x, *, axes, **kw):
        if ctx.avals_in[0].dtype != jnp.bfloat16:
            return orig.rule(ctx, x, axes=axes, **kw)

        def f32_sum(y):
            return lax_internal.reduce_sum_p.bind(
                y.astype(jnp.float32), axes=axes, **kw).astype(jnp.bfloat16)
        return mlir.lower_fun(f32_sum, multiple_results=False)(ctx, x)
    mlir._lowerings[lax_internal.reduce_sum_p] = type(orig)(
        rule=lower, inline=orig.inline)
    try:
        yield
    finally:
        mlir._lowerings[lax_internal.reduce_sum_p] = orig


@contextlib.contextmanager
def bf16_products():
    """JAX's bf16 ``mul`` rounded to bf16, as its dtype says: XLA's CPU
    backend computes a bf16 product in f32 and, where the product is
    converted straight to f32, drops the rounding (excess precision).
    Here the operands and the f32 product are rounded to bf16 precision
    explicitly (``reduce_precision``, which XLA keeps); other dtypes
    unchanged."""
    import jax.numpy as jnp
    from jax import lax
    from jax._src.interpreters import mlir
    from jax._src.lax import lax as lax_internal
    orig = mlir._lowerings[lax_internal.mul_p]

    def bf16_exact(v):
        return lax.reduce_precision(v.astype(jnp.float32), exponent_bits=8,
                                    mantissa_bits=7)

    def lower(ctx, x, y, **kw):
        if ctx.avals_out[0].dtype != jnp.bfloat16:
            return orig.rule(ctx, x, y, **kw)

        def rounded(a, b):
            return bf16_exact(bf16_exact(a) * bf16_exact(b)).astype(
                jnp.bfloat16)
        return mlir.lower_fun(rounded, multiple_results=False)(ctx, x, y)
    mlir._lowerings[lax_internal.mul_p] = type(orig)(rule=lower,
                                                     inline=orig.inline)
    try:
        yield
    finally:
        mlir._lowerings[lax_internal.mul_p] = orig
