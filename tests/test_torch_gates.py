"""The PyTorch port's runs of the JAX package's quality gates on an H100.

``scripts/torch_gates.py`` ran each gate on the card; the finished logs
are committed gzipped under ``tests/data/torch_gates/``.  The bands are
those of ``tests/test_parity_15k.py`` and ``tests/test_canon15k.py``,
measured against the JAX package's committed logs (its "ours" runs under
``tests/data/parity15k/`` and ``tests/data/canon15k/``):

* (a) the 12-epoch run: the two-seed mean MRR over seeds 3408 and 17 at
  most 0.5 points below JAX's mean, each seed at most 3.5 points below
  JAX's; and the same run with ``--dtype bfloat16`` (the JAX package's
  main-path dtype; its committed logs are f32), each seed at most 3.5
  points below JAX's f32 MRR of that seed and the two-seed mean at most
  0.5 points below JAX's f32 mean;
* (b) the IL-heavy 40-epoch run: final MRR at most 3.5 points below JAX's,
  each of the last three common evaluations within 0.06 of JAX's, and
  three promotions or more; in bf16, its final MRR at most 3.5 points
  below JAX's f32 run and three promotions or more;
* (c) the canonical protocol (epoch 1000, il_start 500, eval every 2):
  C1 with >= 490 evaluations, >= 9 promotions, MRR >= 0.80 and
  H@1 >= 0.75; C2, the same command again, with C1's final ``Res:`` line;
  C3 killed after its epoch-599 checkpoint and resumed from it, with >= 7
  promotions after the resume and MRR >= 0.80.

The port holds C2 and C3 tighter than these bands: C2 repeats every
evaluation, promotion and logged loss of C1, and C3's killed and resumed
logs together repeat them too, since its checkpoint keeps the numpy
state and the schedule's horizon (``snag_tpu_torch/utils/checkpoint.py``).

Every log starts with the card's name and power limit and the digests of
the data it trained on, which must be the JAX package's export's.  No JAX
runs here.
"""

import gzip
import os.path as osp
import re
import sys

import pytest

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
PORT = osp.join(REPO, "tests", "data", "torch_gates")
JAX_PARITY = osp.join(REPO, "tests", "data", "parity15k")
JAX_CANON = osp.join(REPO, "tests", "data", "canon15k")
SEEDS = (3408, 17)
RES_RE = re.compile(r"Res:\[([\d.]+)\t([\d.]+)\t([\d.]+)\]")
TRAJ_RE = re.compile(r"Ep (\d+) \| l2r:.*mrr = ([\d.]+)")
# every evaluation, final test, promotion and logged epoch loss
RUN_RE = re.compile(r"(Ep \d+ \| [lr]2[lr]: .*|Res:\[.*\]|"
                    r"#new_links_select:\d+|Ep \[\d+/\d+\] Step \[\d+\] "
                    r"LR \[[\d.]+\] Loss [\d.]+)")
LOGS = ("ours_3408.log", "ours_17.log", "ours_il40_3408.log", "c1_cold.log",
        "c2_repeat.log", "c3_killed.log", "c3_resumed.log",
        "ours_bf16_3408.log", "ours_bf16_17.log", "ours_bf16_il40_3408.log")


def _port(name):
    with gzip.open(osp.join(PORT, name + ".gz"), "rt") as f:
        return f.read()


def _jax(name):
    path = osp.join(JAX_PARITY, name)
    if osp.exists(path):
        with open(path) as f:
            return f.read()
    with gzip.open(osp.join(JAX_CANON, name + ".gz"), "rt") as f:
        return f.read()


def _final_res(text):
    m = RES_RE.findall(text)
    assert m, "no final Res line"
    return tuple(float(v) for v in m[-1])


@pytest.mark.parametrize("name", LOGS)
def test_log_names_its_card_and_data(name):
    sys.path.insert(0, osp.join(REPO, "scripts"))
    from torch_gates import DIGESTS, digest_lines
    lines = _port(name).splitlines()
    assert re.match(r"card: NVIDIA H100.*, [\d.]+ W$", lines[0]), lines[0]
    assert lines[1:1 + len(DIGESTS)] == digest_lines(DIGESTS)
    assert "--device cuda" in lines[1 + len(DIGESTS)]
    assert re.match(r"wall [\d.]+ s, exit code -?\d+$", lines[-1]), lines[-1]


def test_12_epoch_two_seed_mean():
    jax = {s: _final_res(_jax(f"ours_{s}.log"))[2] for s in SEEDS}
    port = {s: _final_res(_port(f"ours_{s}.log"))[2] for s in SEEDS}
    jax_mean = sum(jax.values()) / len(SEEDS)
    port_mean = sum(port.values()) / len(SEEDS)
    report = {"jax": jax, "port": port}
    assert port_mean >= jax_mean - 0.005, report
    for s in SEEDS:
        assert port[s] >= jax[s] - 0.035, (s, report)
    for s in SEEDS:
        text = _port(f"ours_{s}.log")
        assert "[epoch 9]" in text and "candidate set" in text, s


@pytest.mark.parametrize("seed", SEEDS)
def test_12_epoch_bf16_each_seed(seed):
    text = _port(f"ours_bf16_{seed}.log")
    command = next(ln for ln in text.splitlines() if ln.startswith("running:"))
    assert "--dtype bfloat16" in command
    jax = _final_res(_jax(f"ours_{seed}.log"))[2]
    assert _final_res(text)[2] >= jax - 0.035, (_final_res(text), jax)
    assert "[epoch 9]" in text and "candidate set" in text


def test_12_epoch_bf16_two_seed_mean():
    jax = [_final_res(_jax(f"ours_{s}.log"))[2] for s in SEEDS]
    port = [_final_res(_port(f"ours_bf16_{s}.log"))[2] for s in SEEDS]
    assert sum(port) / len(SEEDS) >= sum(jax) / len(SEEDS) - 0.005, (
        port, jax)


def test_il40_bf16():
    port = _port("ours_bf16_il40_3408.log")
    command = next(ln for ln in port.splitlines() if ln.startswith("running:"))
    assert "--dtype bfloat16" in command
    jax = _jax("ours_il40_3408.log")
    assert _final_res(port)[2] >= _final_res(jax)[2] - 0.035
    assert port.count("new_links_select") >= 3


def test_il40():
    port, jax = _port("ours_il40_3408.log"), _jax("ours_il40_3408.log")
    assert _final_res(port)[2] >= _final_res(jax)[2] - 0.035
    port_tr = {int(e): float(m) for e, m in TRAJ_RE.findall(port)}
    jax_tr = {int(e): float(m) for e, m in TRAJ_RE.findall(jax)}
    common = sorted(set(port_tr) & set(jax_tr))
    assert len(common) >= 5, (sorted(port_tr), sorted(jax_tr))
    for ep in common[-3:]:
        assert abs(port_tr[ep] - jax_tr[ep]) < 0.06, (ep, port_tr[ep],
                                                      jax_tr[ep])
    assert port.count("new_links_select") >= 3


def test_canonical_c1():
    text = _port("c1_cold.log")
    assert re.search(r"il_start: 500\b", text)
    assert re.search(r"\bepoch: 1000\b", text)
    assert text.count("| l2r:") >= 490
    assert text.count("new_links_select") >= 9
    h1, h10, mrr = _final_res(text)
    assert mrr >= 0.80 and h1 >= 0.75, (h1, h10, mrr)
    assert "done!" in text


def test_canonical_c2_repeats_c1():
    assert _final_res(_port("c2_repeat.log")) == \
        _final_res(_port("c1_cold.log"))
    assert "done!" in _port("c2_repeat.log")


def test_canonical_c3_kill_and_resume():
    killed, resumed = _port("c3_killed.log"), _port("c3_resumed.log")
    assert "new_links_select" in killed and "done!" not in killed
    assert killed.rstrip().endswith("exit code -15")
    assert re.search(r"resumed from .*checkpoint\.pt \(epoch 599", resumed)
    assert resumed.count("new_links_select") >= 7
    _, _, mrr = _final_res(resumed)
    assert mrr >= 0.80, mrr
    assert "done!" in resumed


def test_canonical_c2_repeats_every_line_of_c1():
    c1 = RUN_RE.findall(_port("c1_cold.log"))
    assert len(c1) > 1000
    assert RUN_RE.findall(_port("c2_repeat.log")) == c1


def test_canonical_c3_killed_and_resumed_repeat_c1():
    c1 = RUN_RE.findall(_port("c1_cold.log"))
    c3 = (RUN_RE.findall(_port("c3_killed.log"))
          + RUN_RE.findall(_port("c3_resumed.log")))
    assert c3 == c1
