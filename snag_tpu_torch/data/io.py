"""Raw file parsing for the MMEA dataset family.

Port of ``snag_tpu/data/io.py``, which mirrors the TSV contracts of the
reference (SNAG_MMEA/src/data.py:406-486): ``ent_ids_{1,2}``,
``ill_ent_ids``, ``triples_{1,2}``, ``training_attrs_{1,2}``.  The parsing
quirks are kept: ``read_tuples`` and ``read_ent2id`` strip only ``"\\n"``,
``get_ids`` and ``read_attrs`` cut each line's last character.
"""

from __future__ import annotations

import json
import os.path as osp
from typing import Dict, List, Sequence, Set, Tuple


def read_tuples(paths: Sequence[str]) -> List[Tuple[int, ...]]:
    out: List[Tuple[int, ...]] = []
    for path in paths:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.strip("\n").split("\t")
                out.append(tuple(int(x) for x in parts))
    return out


def read_ent2id(paths: Sequence[str]) -> Tuple[Dict[str, int], List[Set[int]]]:
    ent2id: Dict[str, int] = {}
    ids: List[Set[int]] = []
    for path in paths:
        cur: Set[int] = set()
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.strip("\n").split("\t")
                ent2id[parts[1]] = int(parts[0])
                cur.add(int(parts[0]))
        ids.append(cur)
    return ent2id, ids


def get_ids(path: str) -> List[int]:
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            out.append(int(line[:-1].split("\t")[0]))
    return out


def read_raw_data(file_dir: str, lang: Sequence[int] = (1, 2)):
    """Parse one MMEA dataset directory (read_raw_data).

    Returns (ent2id_dict, ills, triples, r_hs, r_ts, ids).
    """
    ent2id_dict, ids = read_ent2id([osp.join(file_dir, f"ent_ids_{i}") for i in lang])
    ills = read_tuples([osp.join(file_dir, "ill_ent_ids")])
    triples = read_tuples([osp.join(file_dir, f"triples_{i}") for i in lang])
    r_hs: Dict[int, Set[int]] = {}
    r_ts: Dict[int, Set[int]] = {}
    for h, r, t in triples:
        r_hs.setdefault(r, set()).add(h)
        r_ts.setdefault(r, set()).add(t)
    if len(r_hs) != len(r_ts):
        raise ValueError(f"{file_dir}: {len(r_hs)} relations have heads but "
                         f"{len(r_ts)} have tails")
    return ent2id_dict, ills, triples, r_hs, r_ts, ids


def read_attrs(paths: Sequence[str], ent2id: Dict[str, int]) -> Dict[int, List[str]]:
    """Parse ``training_attrs_*`` files into {ent_id: [attr names]}."""
    out: Dict[int, List[str]] = {}
    for path in paths:
        if not osp.exists(path):
            continue
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line[:-1].split("\t")
                eid = ent2id.get(parts[0])
                if eid is None:
                    continue
                out.setdefault(eid, []).extend(parts[1:])
    return out


def read_ent_names(path: str) -> List[Tuple[int, List[str]]]:
    """Translated entity names JSON (dbp_<split>.json)."""
    with open(path, "r") as f:
        return [(int(i), name) for i, name in json.load(f)]


def resolve_img_pickle(data_path: str, data_choice: str, data_split: str,
                       ratio: str = "1.0") -> str:
    """Per-family image-pickle path resolution (src/data.py:155-172).

    The reference keys on substrings of the SPLIT DIRECTORY (V1/V2/FB), not
    the data_choice, so DWY's dbp_wd_15k_V1/V2 splits route through the
    OpenEA/pkl/<choice>_... naming exactly like the OEA families do; only
    the DBP15K language splits reach the <split>_GA_... fallback."""
    prefix = "" if ratio == "1.0" else f"_{ratio}"
    if "OEA" in data_choice:
        file_dir = osp.join(data_path, "OpenEA", data_choice)
    else:
        file_dir = osp.join(data_path, data_choice, data_split)
    if "V1" in file_dir or "V2" in file_dir:
        return osp.join(data_path, f"OpenEA/pkl/{data_choice}_id_img_feature_dict{prefix}.pkl")
    if "FB" in file_dir:
        return osp.join(data_path, f"pkls/{data_choice}_id_img_feature_dict{prefix}.pkl")
    return osp.join(data_path, "pkls", data_split + f"_GA_id_img_feature_dict{prefix}.pkl")
