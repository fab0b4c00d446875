"""Shared set-up of the ``test_torch_*`` files: one small SNAG geometry,
built as a JAX-package config and as a port config from the same fields."""

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


def jax_snag_params(model, feats, graph, key):
    """The JAX package's SNAG param tree for an inference run: the encoder
    from a jitted init of ``joint_emb`` plus the Kendall layer's zero
    log-variances.  That is the tree ``create_train_state`` builds without
    ``--awloss``, made without tracing the training loss."""
    import jax
    import jax.numpy as jnp
    from snag_tpu.models.snag import SNAG
    params = jax.jit(lambda k: model.init(
        {"params": k}, feats, graph, method=SNAG.joint_emb))(key)["params"]
    return {**params, "multi_loss_layer": {"log_vars": jnp.zeros((6,))}}


def fast_create_train_state(cfg, model, feats, graph, tx, seed,
                            extra_init_kwargs=None):
    """Drop-in for ``snag_tpu.train.step.create_train_state`` with the
    same key split, built on ``jax_snag_params``."""
    import jax
    import jax.numpy as jnp
    from snag_tpu.train.step import TrainState
    init_rng, _, base_key = jax.random.split(jax.random.PRNGKey(seed), 3)
    params = jax_snag_params(model, feats, graph, init_rng)
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


def single_thread():
    # tier-1 runs several xdist workers; one intra-op thread each
    torch.set_num_threads(1)


def snag_pair(data_root: str, **overrides):
    """The same small SNAG in both packages, weights carried across.

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
    from snag_tpu_torch.models.encoder import prepare_features
    from snag_tpu_torch.utils.import_reference import state_dict_from_flax

    jcfg, tcfg = configs(data_root, **overrides)
    jdata = jax_load_data(jcfg)
    jmodel = jax_build_model(jcfg, jdata)
    jfeats = jax_features(jcfg, jdata)
    params = jax.device_get(jax_snag_params(
        jmodel, jfeats, jdata.graph, jax.random.PRNGKey(jcfg.random_seed)))
    params["multi_loss_layer"]["log_vars"] = np.linspace(
        -0.3, 0.4, 6).astype(np.float32)
    tdata = load_data(tcfg)
    tmodel = build_model(tcfg, tdata, torch.Generator().manual_seed(0))
    tmodel.load_state_dict(state_dict_from_flax(params), strict=True)
    return dict(jcfg=jcfg, jmodel=jmodel, jdata=jdata, jfeats=jfeats,
                params=params, tcfg=tcfg, tmodel=tmodel, tdata=tdata,
                tfeats=prepare_features(tcfg, tdata, "cpu"),
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
