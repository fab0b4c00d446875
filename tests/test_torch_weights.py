"""Weights carried across: JAX params -> port state dict, and the
reference ``.pkl`` format both ways, for every ported family: SNAG with
the GAT and with the GCN, EVA (a flat tree), MCLEA (mean fusion, two
Kendall layers; also with ``--use_project_head``) and MEAformer (no
``weight_raw``).  The JAX package's importer maps no projection head, so
the cases through it leave ``MCLEA_heads`` out.  Joint embeddings of a
port-saved ``.pkl`` imported by the JAX package: rtol = atol = 1e-5 (two
frameworks' f32 sums)."""

import jax
import numpy as np
import pytest
import torch

from snag_tpu.data.dataset import load_data as jax_load_data
from snag_tpu.models import build_model as jax_build_model
from snag_tpu.models.encoder import prepare_features as jax_prepare_features
from snag_tpu.utils.import_reference import _ref_key_for as jax_ref_key_for
from snag_tpu.utils.import_reference import (export_reference_state_dict,
                                             import_reference_checkpoint)
from snag_tpu_torch.data.dataset import load_data
from snag_tpu_torch.models import build_model
from snag_tpu_torch.models.encoder import place_features
from snag_tpu_torch.utils.import_reference import (_leaves, _ref_key_for,
                                                   load_reference_checkpoint,
                                                   save_reference_checkpoint,
                                                   state_dict_from_flax)
from torch_port_common import configs, jax_params, single_thread

single_thread()

CASES = {
    "gat": {},
    "gcn": dict(structure_encoder="gcn"),
    "EVA": dict(model_name="EVA"),
    "MCLEA": dict(model_name="MCLEA"),
    "MCLEA_heads": dict(model_name="MCLEA", use_project_head=True),
    "MEAformer": dict(model_name="MEAformer"),
}
JAX_MAPPED = [c for c in CASES if c != "MCLEA_heads"]


@pytest.fixture(scope="module")
def setups(tmp_path_factory):
    cache = {}

    def get(case):
        if case not in cache:
            jcfg, tcfg = configs(str(tmp_path_factory.mktemp(case)),
                                 **CASES[case])
            jdata = jax_load_data(jcfg)
            model = jax_build_model(jcfg, jdata)
            jfeats = jax_prepare_features(jcfg, jdata)
            params = jax.device_get(jax_params(
                model, jfeats, jdata.graph,
                jax.random.PRNGKey(jcfg.random_seed)))
            cache[case] = dict(tcfg=tcfg, data=load_data(tcfg),
                               params=params, jmodel=model, jfeats=jfeats,
                               jgraph=jdata.graph)
        return cache[case]
    return get


def _port_model(tcfg, data, seed=0):
    return build_model(tcfg, data, torch.Generator().manual_seed(seed)).eval()


def _rel_width(model):
    return next(m for name, m in model.named_modules()
                if name.split(".")[-1] == "rel_fc").in_features


@pytest.mark.parametrize("case", JAX_MAPPED)
def test_state_dict_from_flax_matches_export(setups, case):
    """The port's state dict of a JAX tree is the JAX package's reference
    export; the GCN's gc1/gc2 weights are (in, out) in the JAX tree, the
    reference and the port alike."""
    params = setups(case)["params"]
    ours = state_dict_from_flax(params)
    exported = export_reference_state_dict(params)
    assert set(ours) == set(exported)
    for k, v in ours.items():
        want = exported[k]
        if k.endswith("rel_fc.weight"):
            # the export zero-pads rel_fc to the reference's 1000 columns;
            # the port keeps the JAX table width
            assert want.shape[1] == 1000
            np.testing.assert_array_equal(want[:, v.shape[1]:], 0.0)
            want = want[:, :v.shape[1]]
        np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
    for path, leaf in _leaves(params):
        if path[-2:-1] in (("gc1",), ("gc2",)):
            np.testing.assert_array_equal(ours[_ref_key_for(path)[0]].numpy(),
                                          leaf)


@pytest.mark.parametrize("case", list(CASES))
def test_state_dict_loads_strictly_and_keys_match(setups, case):
    s = setups(case)
    model = _port_model(s["tcfg"], s["data"])
    sd = state_dict_from_flax(s["params"])
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert tuple(v.shape) == tuple(sd[k].shape), k
    model.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("case", list(CASES))
def test_ref_keys_match_jax(setups, case):
    """Every leaf of the family's JAX tree gets the reference key JAX's
    ``_ref_key_for`` gives it; the projection heads, which JAX leaves
    unmapped, get the reference ProjectionHead's ``l1`` / ``l2``."""
    flat = jax.tree_util.tree_flatten_with_path(setups(case)["params"])[0]
    unmapped = []
    for jpath, _ in flat:
        path = tuple(str(getattr(k, "key", k)) for k in jpath)
        want, got = jax_ref_key_for(jpath)[0], _ref_key_for(path)[0]
        if want is None:
            unmapped.append(got)
        else:
            assert got == want, path
    assert all(k.endswith((".l1.weight", ".l2.weight")) and "_pro." in k
               for k in unmapped)
    assert len(unmapped) == (8 if case == "MCLEA_heads" else 0)


@pytest.mark.parametrize("case", JAX_MAPPED)
def test_pkl_roundtrip_and_jax_import(setups, case, tmp_path):
    """A port-saved ``.pkl`` loads back into the port tensor for tensor
    and into the JAX package's tree, whose joint embeddings match the
    port's."""
    s = setups(case)
    src = _port_model(s["tcfg"], s["data"], seed=1)
    path = save_reference_checkpoint(src, str(tmp_path / "ref.pkl"))
    raw = torch.load(path, weights_only=True)
    assert [v.shape[1] for k, v in raw.items()
            if k.endswith("rel_fc.weight")] == [1000]

    dst = _port_model(s["tcfg"], s["data"], seed=2)
    dst.load_state_dict(load_reference_checkpoint(
        path, rel_in_dim=_rel_width(src)), strict=True)
    for k, v in src.state_dict().items():
        torch.testing.assert_close(dst.state_dict()[k], v, rtol=0, atol=0)

    # the JAX package imports the port's checkpoint into its own tree
    imported = import_reference_checkpoint(s["params"], path)
    back = state_dict_from_flax(jax.device_get(imported))
    for k, v in src.state_dict().items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    jm = s["jmodel"]
    want, _ = jax.jit(lambda q: jm.apply(
        {"params": q}, s["jfeats"], s["jgraph"],
        method=type(jm).joint_emb))(imported)
    tcfg = s["tcfg"]
    with torch.no_grad():
        got, _ = src.joint_emb(place_features(tcfg, s["data"], "cpu")[0],
                               s["data"].graph.to_torch("cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
