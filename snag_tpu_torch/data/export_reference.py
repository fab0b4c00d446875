"""Export the synthetic KG in the reference's on-disk dataset format.

Port of ``snag_tpu/data/export_reference.py``: numpy over the port's own
``data/synthetic.py``, so both packages write byte-equal files from the
same arguments.

Produces a directory tree the PyTorch reference can consume directly
(SNAG_MMEA/src/data.py:135-272 read path):

    <dest>/<data_choice>/<data_split>/ent_ids_1        "id \t name"
                                      ent_ids_2
                                      ill_ent_ids      "id1 \t id2"
                                      triples_1        "h \t r \t t"
                                      triples_2
                                      training_attrs_1 "name \t attr ..."
                                      training_attrs_2
    <dest>/pkls/<data_split>_GA_id_img_feature_dict.pkl   {id: np.float32[d]}

Three on-disk layouts, selected by ``data_choice`` exactly as the
reference's pickle-resolution switch does (src/data.py:136-171):

  * DBP15K/DWY (default): ``<dest>/<choice>/<split>/`` + the
    ``pkls/<split>_GA_id_img_feature_dict{_ratio}.pkl`` naming above.
  * ``OEA_*``: files under ``<dest>/OpenEA/<choice>/`` (NO split subdir),
    image pickle ``<dest>/OpenEA/pkl/<choice>_id_img_feature_dict{_ratio}.pkl``
    (the reference then rewrites data_split to norm/dense from the V1/V2
    suffix — the split never names a directory for OEA).
  * ``FBDB15K``/``FBYG15K``: files under ``<dest>/<choice>/norm/`` (the
    reference config forces data_split="norm", inner_view_num=4;
    config.py:158-166), image pickle
    ``<dest>/pkls/<choice>_id_img_feature_dict{_ratio}.pkl``.

``ratio`` != "1.0" appends ``_<ratio>`` to the pickle name (the reference's
``data_prefix``, src/data.py:155-157).

Both packages, and the original reference, train on the identical
files.  Formats follow read_raw_data (src/data.py:406-457), load_attr
(src/data.py:489-519) and load_img (src/data.py:551-581).
"""

from __future__ import annotations

import json
import os
import os.path as osp
import pickle

import numpy as np

from snag_tpu_torch.data.synthetic import generate_synthetic_kg


def ent_name(i: int) -> str:
    return f"ent_{i}"


def export_reference_format(dest: str,
                            data_choice: str = "DBP15K",
                            data_split: str = "ja_en",
                            n_ents: int = 2000,
                            n_rels: int = 40,
                            n_triples: int = 8000,
                            img_dim: int = 256,
                            seed: int = 0,
                            noise: float = 0.3,
                            mirror_p: float = 0.7,
                            unalignable_frac: float = 0.0,
                            img_coverage: float = 0.9,
                            with_surface: bool = False,
                            ratio: str = "1.0") -> str:
    """Write the synthetic KG under ``dest``; returns the split directory.

    ``noise``/``mirror_p``/``unalignable_frac`` select the hard parity
    operating points (see synthetic.generate_synthetic_kg).  With
    ``with_surface`` the export also writes the surface-modality inputs the
    reference's load_word_char_features path reads (src/data.py:318-365):
    DBP15K/translated_ent_name/dbp_<split>.json and a fake
    embedding/glove.6B.300d.txt covering every name word, so the name/char
    features both frameworks compute are identical (no missing-word random
    fallback fires)."""
    ills, triples, img_dict, ent_attrs, left, right, kg1, kg2, ent_names = (
        generate_synthetic_kg(n_ents=n_ents, n_rels=n_rels,
                              n_triples=n_triples, img_dim=img_dim,
                              seed=seed, noise=noise, mirror_p=mirror_p,
                              unalignable_frac=unalignable_frac,
                              img_coverage=img_coverage))
    prefix = "" if ratio == "1.0" else f"_{ratio}"
    if "OEA" in data_choice:
        split_dir = osp.join(dest, "OpenEA", data_choice)
        pkl_path = osp.join(dest, "OpenEA", "pkl",
                            f"{data_choice}_id_img_feature_dict{prefix}.pkl")
    elif "FB" in data_choice:
        split_dir = osp.join(dest, data_choice, "norm")
        pkl_path = osp.join(dest, "pkls",
                            f"{data_choice}_id_img_feature_dict{prefix}.pkl")
    elif "V1" in data_split or "V2" in data_split:
        # DWY: <dest>/DWY/dbp_wd_15k_V{1,2}/ but the reference's pickle
        # switch keys on V1/V2 in the split DIR, so the image pickle lives
        # under OpenEA/pkl/<choice>_... like the OEA families
        # (src/data.py:158-163)
        split_dir = osp.join(dest, data_choice, data_split)
        pkl_path = osp.join(dest, "OpenEA", "pkl",
                            f"{data_choice}_id_img_feature_dict{prefix}.pkl")
    else:
        split_dir = osp.join(dest, data_choice, data_split)
        pkl_path = osp.join(
            dest, "pkls",
            f"{data_split}_GA_id_img_feature_dict{prefix}.pkl")
    os.makedirs(split_dir, exist_ok=True)
    os.makedirs(osp.dirname(pkl_path), exist_ok=True)

    def write_rows(name, rows):
        with open(osp.join(split_dir, name), "w", encoding="utf-8") as f:
            for row in rows:
                f.write("\t".join(str(x) for x in row) + "\n")

    write_rows("ent_ids_1", [(i, ent_name(i)) for i in left])
    write_rows("ent_ids_2", [(i, ent_name(i)) for i in right])
    write_rows("ill_ent_ids", ills)
    write_rows("triples_1", kg1)
    write_rows("triples_2", kg2)

    left_set, right_set = set(left), set(right)
    for name, side in (("training_attrs_1", left_set),
                       ("training_attrs_2", right_set)):
        with open(osp.join(split_dir, name), "w", encoding="utf-8") as f:
            for ent, attrs in sorted(ent_attrs.items()):
                if ent in side and attrs:
                    f.write("\t".join([ent_name(ent)] + list(attrs)) + "\n")

    with open(pkl_path, "wb") as f:
        pickle.dump({int(k): np.asarray(v, dtype=np.float32)
                     for k, v in img_dict.items()}, f)

    if with_surface:
        name_dir = osp.join(dest, data_choice, "translated_ent_name")
        os.makedirs(name_dir, exist_ok=True)
        os.makedirs(osp.join(dest, "embedding"), exist_ok=True)
        with open(osp.join(name_dir, f"dbp_{data_split}.json"), "w",
                  encoding="utf-8") as f:
            json.dump([[int(e), list(ws)]
                       for e, ws in sorted(ent_names.items())], f)
        # fake GloVe: one 300-d unit-ish vector per name word, deterministic
        vocab = sorted({w.lower() for ws in ent_names.values() for w in ws})
        wrng = np.random.default_rng(seed + 12345)
        with open(osp.join(dest, "embedding", "glove.6B.300d.txt"), "w",
                  encoding="utf-8") as f:
            for w in vocab:
                vec = wrng.normal(size=300) / np.sqrt(300)
                f.write(w + " " + " ".join(f"{x:.6f}" for x in vec) + "\n")
    return split_dir


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser(
        "python -m snag_tpu_torch.data.export_reference")
    p.add_argument("--dest", required=True)
    p.add_argument("--data_choice", default="DBP15K")
    p.add_argument("--data_split", default="ja_en")
    p.add_argument("--ratio", default="1.0")
    p.add_argument("--n_ents", type=int, default=2000)
    p.add_argument("--n_rels", type=int, default=40)
    p.add_argument("--n_triples", type=int, default=8000)
    p.add_argument("--img_dim", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noise", type=float, default=0.3)
    p.add_argument("--mirror_p", type=float, default=0.7)
    p.add_argument("--unalignable_frac", type=float, default=0.0)
    p.add_argument("--with_surface", action="store_true")
    a = p.parse_args()
    d = export_reference_format(a.dest, data_choice=a.data_choice,
                                data_split=a.data_split, ratio=a.ratio,
                                n_ents=a.n_ents, n_rels=a.n_rels,
                                n_triples=a.n_triples, img_dim=a.img_dim,
                                seed=a.seed, noise=a.noise,
                                mirror_p=a.mirror_p,
                                unalignable_frac=a.unalignable_frac,
                                with_surface=a.with_surface)
    print(f"exported to {d}")
