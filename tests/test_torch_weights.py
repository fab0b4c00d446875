"""Weights carried across: JAX params -> port state dict, and the
reference ``.pkl`` format both ways."""

import jax
import numpy as np
import pytest
import torch

from snag_tpu.data.dataset import load_data as jax_load_data
from snag_tpu.models import build_model as jax_build_model
from snag_tpu.models.encoder import prepare_features as jax_prepare_features
from snag_tpu.utils.import_reference import (export_reference_state_dict,
                                             import_reference_checkpoint)
from snag_tpu_torch.data.dataset import load_data
from snag_tpu_torch.models import build_model
from snag_tpu_torch.utils.import_reference import (load_reference_checkpoint,
                                                   save_reference_checkpoint,
                                                   state_dict_from_flax)
from torch_port_common import configs, jax_snag_params, single_thread

single_thread()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg, tcfg = configs(str(tmp_path_factory.mktemp("weights")))
    jdata = jax_load_data(jcfg)
    model = jax_build_model(jcfg, jdata)
    params = jax.device_get(jax_snag_params(
        model, jax_prepare_features(jcfg, jdata), jdata.graph,
        jax.random.PRNGKey(jcfg.random_seed)))
    return tcfg, load_data(tcfg), params


def _port_model(tcfg, data, seed=0):
    return build_model(tcfg, data, torch.Generator().manual_seed(seed)).eval()


def test_state_dict_from_flax_matches_export(setup):
    _, _, params = setup
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


def test_state_dict_loads_strictly_and_keys_match(setup):
    tcfg, data, params = setup
    model = _port_model(tcfg, data)
    sd = state_dict_from_flax(params)
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert tuple(v.shape) == tuple(sd[k].shape), k
    model.load_state_dict(sd, strict=True)


def test_pkl_roundtrip_and_jax_import(setup, tmp_path):
    tcfg, data, params = setup
    src = _port_model(tcfg, data, seed=1)
    path = save_reference_checkpoint(src, str(tmp_path / "ref.pkl"))
    raw = torch.load(path, weights_only=True)
    assert raw["multimodal_encoder.rel_fc.weight"].shape[1] == 1000

    width = src.multimodal_encoder.rel_fc.in_features
    dst = _port_model(tcfg, data, seed=2)
    dst.load_state_dict(load_reference_checkpoint(path, rel_in_dim=width),
                        strict=True)
    for k, v in src.state_dict().items():
        torch.testing.assert_close(dst.state_dict()[k], v, rtol=0, atol=0)

    # the JAX package imports the port's checkpoint into its own tree
    imported = import_reference_checkpoint(params, path)
    back = state_dict_from_flax(jax.device_get(imported))
    for k, v in src.state_dict().items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


@pytest.fixture(scope="module")
def gcn_setup(tmp_path_factory):
    jcfg, tcfg = configs(str(tmp_path_factory.mktemp("weights_gcn")),
                         structure_encoder="gcn")
    jdata = jax_load_data(jcfg)
    model = jax_build_model(jcfg, jdata)
    params = jax.device_get(jax_snag_params(
        model, jax_prepare_features(jcfg, jdata), jdata.graph,
        jax.random.PRNGKey(jcfg.random_seed)))
    return tcfg, load_data(tcfg), params


def test_gcn_state_dict_from_flax_matches_export_and_loads(gcn_setup):
    """The GCN's gc1/gc2 weights are (in, out) in the JAX tree, the
    reference and the port alike."""
    tcfg, data, params = gcn_setup
    ours = state_dict_from_flax(params)
    exported = export_reference_state_dict(params)
    assert set(ours) == set(exported)
    for i in (1, 2):
        key = f"multimodal_encoder.cross_graph_model.gc{i}.weight"
        np.testing.assert_array_equal(
            ours[key].numpy(),
            params["multimodal_encoder"]["cross_graph_model"][f"gc{i}"]["weight"])
        np.testing.assert_array_equal(ours[key].numpy(), exported[key])
    model = _port_model(tcfg, data)
    assert set(ours) == set(model.state_dict())
    model.load_state_dict(ours, strict=True)


def test_gcn_pkl_roundtrip_and_jax_import(gcn_setup, tmp_path):
    tcfg, data, params = gcn_setup
    src = _port_model(tcfg, data, seed=1)
    path = save_reference_checkpoint(src, str(tmp_path / "gcn.pkl"))
    width = src.multimodal_encoder.rel_fc.in_features
    dst = _port_model(tcfg, data, seed=2)
    dst.load_state_dict(load_reference_checkpoint(path, rel_in_dim=width),
                        strict=True)
    for k, v in src.state_dict().items():
        torch.testing.assert_close(dst.state_dict()[k], v, rtol=0, atol=0)
    back = state_dict_from_flax(jax.device_get(
        import_reference_checkpoint(params, path)))
    for k, v in src.state_dict().items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
