"""The port's on-disk data layer vs the JAX package, small size.

``export_reference_format`` of both packages writes byte-equal text files
and equal image dicts in each of the four layouts (DBP15K, OpenEA, the FB
pair, DWY), with ``ratio`` and ``with_surface``; ``resplit_image_dict``
draws the same subset; and ``load_data`` of both packages on those files
gives equal results, exactly: ills and their split, feature tables,
``ent_wo_img``, graph and non-train lists, with and without ``--unsup``.
The image pickles are compared decoded, since their bytes depend on the
numpy version.
"""

import os
import os.path as osp
import pickle

import numpy as np
import pytest

from snag_tpu.data.dataset import load_data as jax_load_data
from snag_tpu.data.export_reference import \
    export_reference_format as jax_export
from snag_tpu.data.resplit import resplit_image_dict as jax_resplit
from snag_tpu_torch.data import features as F
from snag_tpu_torch.data import io
from snag_tpu_torch.data.dataset import load_data
from snag_tpu_torch.data.export_reference import export_reference_format
from snag_tpu_torch.data.resplit import resplit_image_dict, resplit_pickle
from torch_port_common import assert_graph_equal, configs, single_thread

single_thread()

# a small KG at the hard operating point of the 15K gates, with a tenth of
# the entities lacking an image
GEOMETRY = dict(n_ents=300, n_rels=12, n_triples=1200, img_dim=16, seed=3,
                noise=1.2, mirror_p=0.4, unalignable_frac=0.35,
                img_coverage=0.9)
# (data_choice, data_split, export options)
LAYOUTS = {
    "dbp15k": ("DBP15K", "ja_en", {}),
    "dbp15k_surface": ("DBP15K", "ja_en", {"with_surface": True}),
    "dbp15k_ratio": ("DBP15K", "ja_en", {"ratio": "0.5"}),
    "openea": ("OEA_EN_FR_15K_V1", "norm", {}),
    "fb": ("FBDB15K", "norm", {}),
    "dwy": ("DWY", "dbp_wd_15k_V1", {}),
}


def _export(root, name):
    choice, split, kw = LAYOUTS[name]
    dest = {side: osp.join(root, name, side) for side in ("jax", "port")}
    jax_export(dest["jax"], data_choice=choice, data_split=split,
               **GEOMETRY, **kw)
    export_reference_format(dest["port"], data_choice=choice,
                            data_split=split, **GEOMETRY, **kw)
    return dest


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("exports"))
    return {name: _export(root, name) for name in LAYOUTS}


def _tree(dest):
    return sorted(osp.relpath(osp.join(d, f), dest)
                  for d, _, files in os.walk(dest) for f in files)


def _load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_same_img_dict(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_export_matches_jax(exports, name):
    dest = exports[name]
    files = _tree(dest["jax"])
    assert files == _tree(dest["port"])
    pkls = [f for f in files if f.endswith(".pkl")]
    assert len(pkls) == 1
    for rel in files:
        a, b = (osp.join(dest[s], rel) for s in ("jax", "port"))
        if rel.endswith(".pkl"):
            _assert_same_img_dict(_load_pickle(a), _load_pickle(b))
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel
    choice, split, kw = LAYOUTS[name]
    want = io.resolve_img_pickle(dest["port"], choice, split,
                                 kw.get("ratio", "1.0"))
    assert osp.relpath(want, dest["port"]) == pkls[0]


def test_resplit_matches_jax(exports, tmp_path):
    dest = exports["dbp15k"]["port"]
    pkl = io.resolve_img_pickle(dest, "DBP15K", "ja_en")
    img = _load_pickle(pkl)
    ills = io.read_tuples([osp.join(dest, "DBP15K", "ja_en", "ill_ent_ids")])
    for ratio, seed in ((0.3, 0), (0.6, 5), (1.0, 1)):
        got = resplit_image_dict(img, ills, ratio, seed)
        _assert_same_img_dict(jax_resplit(img, ills, ratio, seed), got)
        n_ill = 2 * len(ills)
        with_img = {e for pair in ills for e in pair if e in got}
        assert len(with_img) == min(int(ratio * n_ill),
                                    len({e for p in ills for e in p
                                         if e in img}))
    out = resplit_pickle(pkl, str(tmp_path / "img_0.3.pkl"), ills, 0.3)
    _assert_same_img_dict(_load_pickle(out),
                          jax_resplit(img, ills, 0.3, 0))


def test_parsers_keep_the_reference_quirks(tmp_path):
    """``get_ids`` and ``read_attrs`` cut the last character of a line,
    ``read_tuples`` strips only the newline; a GloVe line of another
    width is skipped."""
    p = tmp_path / "rows"
    p.write_text("4\tent_4\n7\tent_7\n")
    assert io.get_ids(str(p)) == [4, 7]
    t = tmp_path / "t"
    t.write_text("1\t2\t3\n4\t5\t6\n")
    assert io.read_tuples([str(t)]) == [(1, 2, 3), (4, 5, 6)]
    a = tmp_path / "attrs"
    # the unterminated last line loses its last character, as in the
    # reference
    a.write_text("ent_4\tx\ty\nent_9\tz\nent_7\tw")
    assert io.read_attrs([str(a), str(tmp_path / "missing")],
                         {"ent_4": 4, "ent_7": 7}) == {4: ["x", "y"], 7: [""]}
    g = tmp_path / "glove"
    g.write_text("Cat 0.5 -1\ndog 1 2 3\nbad x 1\n")
    w2v = F.load_word2vec(str(g), dim=2)
    assert list(w2v) == ["cat"]
    np.testing.assert_array_equal(w2v["cat"], [0.5, -1.0])


def _assert_same_data(jd, td):
    assert (td.ent_num, td.rel_num) == (jd.ent_num, jd.rel_num)
    assert td.triples == jd.triples
    for name in ("img_features", "rel_features", "att_features",
                 "train_ill", "test_ill", "name_features", "char_features"):
        a, b = getattr(td, name), getattr(jd, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("ent_wo_img", "ent_w_img", "left_ents", "right_ents",
                 "left_non_train", "right_non_train", "test_ill_set",
                 "kg1_triples", "kg2_triples"):
        assert getattr(td, name) == getattr(jd, name), name
    assert_graph_equal(jd.graph, td.graph)


# (layout, config overrides); the unsup cases seed the train set from
# image or name similarity
LOAD_CASES = {
    "dbp15k": ("dbp15k", {}),
    "dbp15k_surface": ("dbp15k_surface", {"use_surface": 1}),
    "dbp15k_ratio": ("dbp15k_ratio", {"ratio": "0.5", "data_rate": 0.5}),
    "openea": ("openea", {}),
    "fb": ("fb", {}),
    "dwy": ("dwy", {}),
    "unsup_img": ("dbp15k", {"unsup": True, "unsup_mode": "img",
                             "unsup_k": 20}),
    "unsup_name": ("dbp15k_surface", {"unsup": True, "unsup_mode": "name",
                                      "unsup_k": 20, "use_surface": 1}),
}


@pytest.mark.parametrize("case", sorted(LOAD_CASES))
def test_load_data_on_files_matches_jax(exports, tmp_path, case):
    layout, overrides = LOAD_CASES[case]
    choice, split, _ = LAYOUTS[layout]
    kw = dict(data_choice=choice, data_split=split, random_seed=11,
              **overrides)
    jcfg, _ = configs(str(tmp_path), data_path=exports[layout]["jax"], **kw)
    _, tcfg = configs(str(tmp_path), data_path=exports[layout]["port"], **kw)
    jd, td = jax_load_data(jcfg), load_data(tcfg)
    _assert_same_data(jd, td)
    assert td.ent_num == GEOMETRY["n_ents"]
    assert len(td.ent_wo_img) > 0
    if overrides.get("use_surface"):
        assert td.name_features.shape == (td.ent_num, 300)
    if overrides.get("unsup"):
        assert 0 < len(td.train_ill) <= overrides["unsup_k"]
        assert len(td.test_ill) == len(io.read_tuples([osp.join(
            tcfg.data_path, choice, split, "ill_ent_ids")]))


def test_load_data_refuses_unsup_name_without_surface(exports, tmp_path):
    _, tcfg = configs(str(tmp_path), data_path=exports["dbp15k"]["port"],
                      data_choice="DBP15K", data_split="ja_en", unsup=True,
                      unsup_mode="name")
    with pytest.raises(ValueError, match="--use_surface 1"):
        load_data(tcfg)
