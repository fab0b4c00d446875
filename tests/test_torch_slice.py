"""The port's inference slice end to end vs the JAX package, small size.

With the JAX params carried across, the port's ``joint_emb`` matches, and
``--only_test`` gives the ranks, metrics and top-3 CSV that
``snag_tpu.train.runner.Runner.evaluate(last_epoch=True)`` computes and
writes.  The two frameworks sum matmuls in different orders on the CPU,
so a query whose gold distance lies within 1e-6 of a competitor's may
flip; only such queries may differ, and this seeded case has none.
"""

import csv
import os.path as osp
import subprocess
import sys
import unittest.mock as mock

import jax
import numpy as np
import pytest
import torch

import snag_tpu.train.runner as jax_runner_mod
from snag_tpu.utils.import_reference import export_reference_checkpoint
from snag_tpu.utils.logging import create_logger as jax_logger
from snag_tpu_torch.cli.train_mmea import main as port_main
from snag_tpu_torch.ops.cuda import rank_eval as trk
from snag_tpu_torch.ops.fusion import l2norm
from snag_tpu_torch.train.runner import Runner
from snag_tpu_torch.utils.import_reference import state_dict_from_flax
from snag_tpu_torch.utils.logging import create_logger
from torch_port_common import (SMALL, configs, fast_create_train_state,
                               single_thread)

single_thread()
NEAR_TIE = 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("slice"))
    jcfg, tcfg = configs(root)
    with mock.patch.object(jax_runner_mod, "create_train_state",
                           fast_create_train_state):
        jr = jax_runner_mod.Runner(jcfg, jax_logger(name="slice_jax"))
    jres = jr.evaluate(last_epoch=True, save_name="jax")
    params = jax.device_get(jr.state.params)

    tr = Runner(tcfg, create_logger(name="slice_torch"))
    tr.model.load_state_dict(state_dict_from_flax(params), strict=True)
    tres = tr.evaluate(last_epoch=True, save_name="torch")
    return dict(root=root, jr=jr, jres=jres, params=params, tr=tr, tres=tres)


def _csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def _pred_path(cfg, save_name):
    return osp.join(cfg.data_path, cfg.model_name, f"{save_name}_pred",
                    f"{cfg.data_choice}_pred.txt")


def _near_tie_rows(runner):
    """Queries whose gold CSLS distance is within NEAR_TIE of another
    column's, from the port's own dense distances."""
    with torch.no_grad():
        emb = l2norm(runner._joint_emb()[0])
        d = trk.pairwise_distances(emb[runner.test_left],
                                   emb[runner.test_right])
        d = 1 - trk.csls_sim(1 - d, runner.cfg.csls_k)
    gold = torch.diagonal(d)[:, None]
    close = (d - gold).abs() < NEAR_TIE
    close.fill_diagonal_(False)
    return set(torch.nonzero(close.any(dim=1))[:, 0].tolist())


def _assert_same_eval(jres, jcsv, tres, tcsv, runner):
    differ = set(np.nonzero(tres.ranks_l2r != jres.ranks_l2r)[0].tolist())
    differ |= set(np.nonzero((tres.top3_l2r != jres.top3_l2r).any(1))[0].tolist())
    assert differ <= _near_tie_rows(runner), sorted(differ)
    if not differ:
        np.testing.assert_array_equal(tres.acc_l2r, jres.acc_l2r)
        np.testing.assert_array_equal(tres.acc_r2l, jres.acc_r2l)
        assert (tres.mr_l2r, tres.mrr_l2r) == (jres.mr_l2r, jres.mrr_l2r)
        assert (tres.mr_r2l, tres.mrr_r2l) == (jres.mr_r2l, jres.mrr_r2l)
    assert len(tcsv) == len(jcsv) == len(runner.test_left) + 1
    for i, (a, b) in enumerate(zip(tcsv, jcsv)):
        if i - 1 not in differ:
            assert a == b, (i, a, b)


def test_joint_emb_matches_jax(runs):
    jr, tr = runs["jr"], runs["tr"]
    want_joint, want_w = jr._joint_emb()
    got_joint, got_w = tr._joint_emb()
    np.testing.assert_allclose(got_joint.numpy(), np.asarray(want_joint),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w),
                               rtol=1e-5, atol=1e-5)


def test_only_test_eval_matches_jax_runner(runs):
    jr, tr = runs["jr"], runs["tr"]
    _assert_same_eval(runs["jres"], _csv(_pred_path(jr.cfg, "jax")),
                      runs["tres"], _csv(tr.pred_path), tr)


def test_cli_only_test_loads_reference_pkl(runs, tmp_path):
    """The CLI path: a JAX-exported reference .pkl through
    ``--model_name_save`` and ``--only_test 1`` on the CPU."""
    pkl = export_reference_checkpoint(runs["params"], str(tmp_path / "m.pkl"))
    argv = ["--only_test", "1", "--model_name_save", pkl, "--device", "cpu",
            "--data_path", str(tmp_path), "--csls"]
    for k, v in SMALL.items():
        if k in ("csls", "no_tensorboard", "add_noise"):
            continue
        argv += [f"--{k}", str(v)]
    before = trk.STATS_RANKS.twin_calls
    runner = port_main(argv)
    assert trk.STATS_RANKS.twin_calls == before + 1
    res = runner.last_result
    assert np.isfinite(res.mrr_l2r) and 0 <= res.mrr_l2r <= 1
    lines = _csv(runner.pred_path)
    assert lines[0] == ["idx", "rank", "query_id", "gt_id", "ret1", "ret2",
                        "ret3"]
    jr = runs["jr"]
    _assert_same_eval(runs["jres"], _csv(_pred_path(jr.cfg, "jax")),
                      runs["tres"], lines, runs["tr"])


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, snag_tpu_torch\n"
        "for m in pkgutil.walk_packages(snag_tpu_torch.__path__, 'snag_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'snag_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
