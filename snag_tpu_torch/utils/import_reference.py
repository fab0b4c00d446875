"""Weights carried across: JAX params, reference checkpoints, and back.

The port's modules carry the reference's torch names (SNAG, MEAformer and
MCLEA nest the shared encoder under ``multimodal_encoder``; EVA's tree is
flat), so:

* ``state_dict_from_flax`` maps the JAX package's param tree (nested dicts
  of numpy arrays, e.g. after ``jax.device_get``) onto the port's state
  dict with the rules of ``snag_tpu/utils/import_reference.py::_ref_key_for``
  (:57-100): Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in),
  LayerNorm ``scale`` -> ``weight``, the GCN's ``gc1``/``gc2`` weights
  (in, out) as they are; ``rel_fc`` keeps the JAX table width; the GAT's
  instance normalisation (``--instance_normalization``) ``in_scale`` and
  ``in_bias`` -> ``cross_graph_model.norm.weight`` and ``.bias``, which the
  JAX package's importer leaves unmapped.  Beyond
  those rules it maps the projection heads (``--use_project_head``,
  ``{img,att,rel,gph}_pro.l{1,2}``, the reference's ProjectionHead
  names), which the JAX package's importer leaves unmapped; and MSNEA's
  tree (``ent_embed``, ``rel_embed``, ``fc1``, ``fc3``,
  ``attr_encoder/fc1``, ``name_fc``, ``char_fc``), which the JAX
  package's importer does not map either (its :17-18): a ``.pkl`` the port
  writes for MSNEA carries the port's own names, and only the port reads
  it back; and MKGC's tree (``ent_emb``, ``rel_emb``, ``vis_proj[2]``,
  ``txt_proj[2]``, ``gate``, ``modal_weight``, ``fusion_{i}``), whose port
  names are the JAX ones, each fusion layer's inside named as MMEA's;
* ``load_reference_checkpoint`` reads a reference ``.pkl``
  (``torch.save(model.state_dict())``, SNAG_MMEA/main.py:481-500) and
  truncates ``rel_fc.weight`` to our relation-table width: both sides use
  ``Counter.most_common`` column order and the reference's extra columns
  only ever see zeros (import_reference.py:126-133);
* ``save_reference_checkpoint`` writes that format, ``rel_fc`` zero-padded
  back to the reference's 1000 columns.

Plain Python over numpy; no JAX import.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

_T = "transpose"      # flax Dense kernel (in, out) -> torch weight (out, in)
_ID = "identity"

_FUSION_LAYER = {
    ("self", "query", "kernel"): ("attention.self.query.weight", _T),
    ("self", "query", "bias"): ("attention.self.query.bias", _ID),
    ("self", "key", "kernel"): ("attention.self.key.weight", _T),
    ("self", "key", "bias"): ("attention.self.key.bias", _ID),
    ("self", "value", "kernel"): ("attention.self.value.weight", _T),
    ("self", "value", "bias"): ("attention.self.value.bias", _ID),
    ("att_out", "kernel"): ("attention.output.dense.weight", _T),
    ("att_out", "bias"): ("attention.output.dense.bias", _ID),
    ("att_ln", "scale"): ("attention.output.LayerNorm.weight", _ID),
    ("att_ln", "bias"): ("attention.output.LayerNorm.bias", _ID),
    ("intermediate", "kernel"): ("intermediate.dense.weight", _T),
    ("intermediate", "bias"): ("intermediate.dense.bias", _ID),
    ("output", "kernel"): ("output.dense.weight", _T),
    ("output", "bias"): ("output.dense.bias", _ID),
    ("out_ln", "scale"): ("output.LayerNorm.weight", _ID),
    ("out_ln", "bias"): ("output.LayerNorm.bias", _ID),
}

REL_IN_DIM = 1000     # the reference's fixed relation-bag width

# --instance_normalization: the GAT's affine (snag_tpu/ops/gnn.py:196-197)
# as torch's InstanceNorm1d(affine=True) names it, under the GAT's ``norm``
_INSTANCE_NORM = {"in_scale": "norm.weight", "in_bias": "norm.bias"}


# MKGC's Dense layers (snag_tpu/mkgc/model.py:74-93), named alike in the port
_MKGC_DENSE = ("vis_proj", "txt_proj", "vis_proj2", "txt_proj2", "gate")


def _mkgc_key_for(keys: Tuple[str, ...]):
    """Port key + transform of one MKGC param path: the tables and
    ``modal_weight`` by name, the Dense layers transposed, ``fusion_{i}``
    through the MMEA fusion layer's names."""
    if keys in (("ent_emb",), ("rel_emb",), ("modal_weight",)):
        return keys[0], _ID
    if len(keys) == 2 and keys[0] in _MKGC_DENSE:
        if keys[1] == "kernel":
            return f"{keys[0]}.weight", _T
        return f"{keys[0]}.bias", _ID
    if keys[0].startswith("fusion_") and keys[0][7:].isdigit():
        tail = _FUSION_LAYER.get(tuple(keys[1:]))
        if tail is not None:
            return f"{keys[0]}.{tail[0]}", tail[1]
    return None, None


def _ref_key_for(keys: Tuple[str, ...]):
    """Reference state-dict key + transform for one JAX param path."""
    key, tf = _mkgc_key_for(keys)
    if key is not None:
        return key, tf
    if keys[0] == "multimodal_encoder":
        rest, prefix = keys[1:], "multimodal_encoder."
    else:
        rest, prefix = keys, ""

    if rest in (("entity_emb",), ("ent_embed",), ("rel_embed",)):
        return f"{prefix}{rest[0]}.weight", _ID
    if rest == ("weight_raw",):
        return f"{prefix}weight_raw", _ID
    if rest[0] == "attr_encoder":       # MSNEA's AttrEncoder.fc1
        rest, prefix = rest[1:], f"{prefix}attr_encoder."
    if len(rest) == 2 and (rest[0].endswith("_fc")
                           or rest[0] in ("fc1", "fc3")):
        if rest[1] == "kernel":
            return f"{prefix}{rest[0]}.weight", _T
        return f"{prefix}{rest[0]}.bias", _ID
    if rest[0] == "cross_graph_model" and len(rest) == 2 and \
            rest[1] in _INSTANCE_NORM:
        return f"{prefix}cross_graph_model.{_INSTANCE_NORM[rest[1]]}", _ID
    if rest[0] == "cross_graph_model" and len(rest) == 3:
        name, leaf = rest[1], rest[2]
        if name.startswith("gat_"):     # gat_{i} -> layer_stack.{i}
            i = name.split("_", 1)[1]
            return f"{prefix}cross_graph_model.layer_stack.{i}.{leaf}", _ID
        if name.startswith("gc"):       # gc1/gc2: weight is (in, out) in both
            return f"{prefix}cross_graph_model.{name}.{leaf}", _ID
    if rest[0] == "fusion":
        if rest[1] == "weight_raw":
            return f"{prefix}fusion.weight_raw", _ID
        if rest[1] == "weight":         # MCLEA MultiModalFusion.weight
            return f"{prefix}fusion.weight", _ID
        if rest[1].startswith("layer_"):
            i = rest[1].split("_", 1)[1]
            tail = _FUSION_LAYER.get(tuple(rest[2:]))
            if tail is not None:
                ref_tail, tf = tail
                return f"{prefix}fusion.fusion_layer.{i}.{ref_tail}", tf

    if len(rest) == 3 and rest[0].endswith("_pro") and rest[2] == "kernel":
        return f"{prefix}{rest[0]}.{rest[1]}.weight", _T

    if len(keys) == 2 and keys[1] in ("log_vars", "params") and \
            keys[0].endswith(("multi_loss_layer", "multi_loss_layer_2")):
        return f"{keys[0]}.{keys[1]}", _ID
    return None, None


def _leaves(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (str(k),))
        else:
            yield path + (str(k),), v


def state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """JAX param tree (nested dicts of numpy arrays) -> the port's state
    dict, loadable with ``model.load_state_dict(strict=True)``."""
    out = {}
    for path, leaf in _leaves(params):
        key, tf = _ref_key_for(path)
        if key is None:
            raise KeyError(f"no port parameter for {'/'.join(path)}")
        arr = np.asarray(leaf, dtype=np.float32)
        if tf == _T:
            arr = arr.T
        out[key] = torch.tensor(arr)
    return out


def load_reference_checkpoint(path: str, rel_in_dim: Optional[int] = None
                              ) -> Dict[str, torch.Tensor]:
    """Read a reference ``.pkl`` state dict onto the CPU; with
    ``rel_in_dim``, truncate ``rel_fc.weight``'s input columns to it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out = {}
    for k, v in sd.items():
        v = v.detach()
        if rel_in_dim is not None and k.endswith("rel_fc.weight"):
            if v.shape[1] < rel_in_dim:
                raise ValueError(f"{k}: reference input dim {v.shape[1]} < "
                                 f"ours {rel_in_dim}")
            v = v[:, :rel_in_dim].contiguous()
        out[k] = v
    return out


def save_reference_checkpoint(model: nn.Module, path: str,
                              rel_in_dim: int = REL_IN_DIM) -> str:
    """``torch.save`` the model's state dict in the reference format."""
    sd = {}
    for k, v in model.state_dict().items():
        v = v.detach().to("cpu", torch.float32)
        if k.endswith("rel_fc.weight") and v.shape[1] < rel_in_dim:
            v = torch.cat([v, v.new_zeros(v.shape[0], rel_in_dim - v.shape[1])],
                          dim=1)
        sd[k] = v.contiguous()
    torch.save(sd, path)
    return path
