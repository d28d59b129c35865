"""Reference-checkpoint converter (``ds_to_universal`` CLI); the port's own
copy of ``deepspeed_tpu/checkpoint/ds_to_universal.py``, which imports
nothing of JAX (run it as ``python -m
deepspeed_tpu_torch.checkpoint.ds_to_universal``).

Reads a checkpoint directory written by the reference framework —
``mp_rank_*_model_states.pt`` plus per-dp-rank
``(bf16_|fp16_)?zero_pp_rank_*_mp_rank_*_optim_states.pt`` — and writes this
framework's name-keyed universal layout, so a training run started on the
reference can resume here. Mirrors the reference's offline converter
(``checkpoint/ds_to_universal.py:469`` main: extract zero shards -> merge ->
universal dir) and the fp32 reconstruction of ``utils/zero_to_fp32.py``.

The torch ``.pt`` containers are read through ``torch.load`` (on the CPU);
only the checkpoint KEY NAMES are reference-compatible surface, the
reconstruction below is this framework's own.

Scope: ZeRO stage 1/2 checkpoints (per-rank contiguous fp32 flat
partitions; stage-2's 2*world alignment honored), ZeRO stage-3 checkpoints
(per-PARAM zip partitioning: every param splits into world ceil-sized
fragments, one per rank, packed in declaration order — the layout
``utils/zero_to_fp32.py:_zero3_merge_trainable_params`` documents), and
plain module-state checkpoints — each at any dp world size and any mp
degree (per-mp-rank reconstruction, then TP-slice merge; ambiguous merges
REFUSE with a ``--cat-dim`` escape hatch rather than guessing dim 0).

Output layout (``universal_named``):

    <out_dir>/
      latest                   # tag
      <tag>/
        params.npz             # param name -> fp32 ndarray
        meta.json
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Any, Dict, List, Optional

import numpy as np

# reference checkpoint key names (compatibility surface: the
# reference framework's deepspeed/checkpoint/constants.py)
_OPT = "optimizer_state_dict"
_FLAT_KEYS = ("fp32_flat_groups", "single_partition_of_fp32_groups")
_PARAM_SHAPES = "param_shapes"
_ZERO_STAGE = "zero_stage"
_PARTITION_COUNT = "partition_count"
_MODULE = "module"

META_FORMAT = "universal_named_v1"


def _read_pt(path: str) -> Any:
    import torch
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        # reference checkpoints carry argparse namespaces etc.; loading a
        # checkpoint is as trusted as training from it
        return torch.load(path, map_location="cpu", weights_only=False)


def _to_np(t: Any) -> np.ndarray:
    import torch
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.to(torch.float32).numpy()
        return t.detach().numpy()
    return np.asarray(t)


def _find(dirname: str, pattern: str) -> List[str]:
    rx = re.compile(pattern)
    # numeric sort: reference filenames carry UNPADDED ranks, and a
    # lexicographic order would interleave rank 10 between 1 and 2 —
    # silently permuting the concatenated fp32 partitions
    return sorted((f for f in os.listdir(dirname) if rx.fullmatch(f)),
                  key=lambda f: [int(x) for x in re.findall(r"\d+", f)])


def _merge_tp_slices(name: str, slices: List[np.ndarray],
                     full_shape: Optional[tuple] = None,
                     cat_dim_rules: Optional[Dict[str, int]] = None
                     ) -> np.ndarray:
    """Merge one param's mp_rank slices. Equal slices = replicated
    (layernorms, biases of row-parallel layers). Split tensors concatenate
    on: the dim a matching ``cat_dim_rules`` regex names, else the unique
    dim that reproduces ``full_shape`` when known, else REFUSE — a
    dim-0 default would produce a wrong-shaped-but-plausible merge for
    row-parallel layers and corrupt the resume silently. The reference
    resolves the same ambiguity with per-pattern rules
    (checkpoint/universal_checkpoint.py load_hp_checkpoint_state); pass
    ``--cat-dim 'regex=dim'`` for each split layer family."""
    if len(slices) == 1:
        return slices[0]
    first = slices[0]
    if all(s.shape == first.shape and np.array_equal(s, first)
           for s in slices[1:]):
        return first
    for pat, dim in (cat_dim_rules or {}).items():
        if re.search(pat, name):
            return np.concatenate(slices, axis=dim)
    if full_shape is not None:
        dims = [d for d in range(first.ndim)
                if np.concatenate(slices, axis=d).shape == tuple(full_shape)]
        if len(dims) == 1:
            return np.concatenate(slices, axis=dims[0])
    raise ValueError(
        f"{name}: cannot determine the tensor-parallel concat dim "
        f"(slices {[tuple(s.shape) for s in slices]}); pass "
        f"--cat-dim '<regex matching this name>=<dim>' — e.g. row-parallel "
        f"torch Linears split dim 1")


def extract_fp32_state(ckpt_dir: str,
                       cat_dim_rules: Optional[Dict[str, int]] = None
                       ) -> Dict[str, np.ndarray]:
    """Reconstruct {param name: fp32 array} from a reference tag dir."""
    model_files = _find(ckpt_dir, r"mp_rank_\d+_model_states\.pt")
    if not model_files:
        raise FileNotFoundError(
            f"no mp_rank_*_model_states.pt under {ckpt_dir}")
    zero_files = _find(
        ckpt_dir, r"(bf16_|fp16_)?zero_pp_rank_\d+_mp_rank_\d+"
                  r"_optim_states\.pt")

    if not zero_files:
        # plain (non-zero) checkpoint: module state is the source of truth
        per_name: Dict[str, List[np.ndarray]] = {}
        for mf in model_files:
            sd = _read_pt(os.path.join(ckpt_dir, mf))[_MODULE]
            for k, v in sd.items():
                per_name.setdefault(k, []).append(_to_np(v))
        return {k: _merge_tp_slices(k, v, cat_dim_rules=cat_dim_rules)
                .astype(np.float32) for k, v in per_name.items()}

    # group zero files by mp rank: each mp rank is an independent ZeRO
    # world whose flat partitions cover that rank's TP slice of the model;
    # reconstruct per mp rank, then merge the TP slices
    by_mp: Dict[int, List[str]] = {}
    for f in zero_files:
        mp = int(re.search(r"mp_rank_(\d+)", f).group(1))
        by_mp.setdefault(mp, []).append(f)
    mp_states = {}
    for mf in model_files:
        mp = int(re.search(r"mp_rank_(\d+)", mf).group(1))
        mp_states[mp] = _read_pt(os.path.join(ckpt_dir, mf))
    if sorted(by_mp) != sorted(mp_states):
        raise ValueError(
            f"mp ranks mismatch: model states {sorted(mp_states)} vs zero "
            f"files {sorted(by_mp)}")

    per_mp: List[Dict[str, np.ndarray]] = []
    for mp in sorted(by_mp):
        state = mp_states[mp]
        if _PARAM_SHAPES not in state:
            raise KeyError(
                f"mp_rank_{mp:02d}_model_states lacks '{_PARAM_SHAPES}' — "
                f"cannot map flat fp32 partitions back to named parameters")
        per_mp.append(_reconstruct_mp_rank(
            ckpt_dir, by_mp[mp], state[_PARAM_SHAPES]))

    if len(per_mp) == 1:
        return per_mp[0]
    per_name: Dict[str, List[np.ndarray]] = {}
    for d in per_mp:
        for k, v in d.items():
            per_name.setdefault(k, []).append(v)
    return {k: _merge_tp_slices(k, v, cat_dim_rules=cat_dim_rules)
            for k, v in per_name.items()}


def _reconstruct_mp_rank(ckpt_dir: str, zero_files: List[str],
                         param_shapes) -> Dict[str, np.ndarray]:
    """One mp rank's ZeRO world -> {name: fp32 array} (that rank's slice)."""
    rank_sds = [_read_pt(os.path.join(ckpt_dir, f))[_OPT]
                for f in zero_files]
    stage = int(rank_sds[0].get(_ZERO_STAGE, 1))
    world = rank_sds[0].get(_PARTITION_COUNT, len(zero_files))
    if isinstance(world, (list, tuple)):
        world = int(max(world))
    world = int(world)
    if world != len(zero_files):
        raise ValueError(
            f"partition_count {world} != {len(zero_files)} zero files")

    flat_key = next((k for k in _FLAT_KEYS if k in rank_sds[0]), None)
    if flat_key is None:
        raise KeyError(
            f"none of {_FLAT_KEYS} in {zero_files[0]}; unsupported layout")

    if stage >= 3:
        return _reconstruct_stage3(rank_sds, param_shapes, flat_key, world)

    out: Dict[str, np.ndarray] = {}
    for g, shapes in enumerate(param_shapes):
        parts = []
        for sd in rank_sds:
            grp = sd[flat_key][g]
            parts.append(_to_np(grp).reshape(-1).astype(np.float32))
        full = np.concatenate(parts)
        total = sum(int(np.prod(tuple(s))) for s in shapes.values())
        if full.size < total:
            raise ValueError(
                f"group {g}: flat partitions hold {full.size} elements, "
                f"params need {total}")
        # params pack CONTIGUOUSLY; stage 2 pads only the END of the group
        # (to 2*world) before splitting across ranks — verify the trailing
        # pad is within that bound so a mis-read fails loudly
        align = 2 * world if stage >= 2 else world
        if full.size - total >= align + world:
            raise ValueError(
                f"group {g}: {full.size - total} trailing elements exceeds "
                f"the stage-{stage} alignment bound ({align + world}); "
                f"param_shapes do not match these flat partitions")
        offset = 0
        for name, shape in shapes.items():
            shape = tuple(int(x) for x in shape)
            n = int(np.prod(shape)) if shape else 1
            out[name] = full[offset:offset + n].reshape(shape)
            offset += n
    return out


def _reconstruct_stage3(rank_sds, param_shapes, flat_key: str,
                        world: int) -> Dict[str, np.ndarray]:
    """Stage-3 layout (reference ``extract_zero_shards_stage3``,
    checkpoint/ds_to_universal.py:152, and ``zero_to_fp32.py``
    ``_zero3_merge_trainable_params``): parameters partition PER PARAM —
    every param of U elements splits into ``world`` fragments of
    ceil(U/world) (last one zero-padded), rank i's flat buffer holding
    fragment i of each param in declaration order. Reconstruction zips the
    rank buffers at each param boundary and trims the padding."""
    # stage-3 sub-group flat tensors concatenate into one buffer per rank
    flats = []
    for sd in rank_sds:
        grp = sd[flat_key]
        if not isinstance(grp, (list, tuple)):
            grp = [grp]
        flats.append(np.concatenate(
            [_to_np(g).reshape(-1).astype(np.float32) for g in grp]))
    # param_shapes: list of {name: shape} per group -> one ordered dict
    if isinstance(param_shapes, dict):
        shapes = dict(param_shapes)
    else:
        shapes = {k: v for d in param_shapes for k, v in d.items()}

    out: Dict[str, np.ndarray] = {}
    offset = 0
    for name, shape in shapes.items():
        shape = tuple(int(x) for x in shape)
        U = int(np.prod(shape)) if shape else 1
        pn = -(-U // world)
        if offset + pn > flats[0].size:
            raise ValueError(
                f"{name}: stage-3 fragment [{offset}:{offset + pn}] exceeds "
                f"rank buffer ({flats[0].size} elements); param_shapes do "
                f"not match these flat partitions")
        out[name] = np.concatenate(
            [f[offset:offset + pn] for f in flats])[:U].reshape(shape)
        offset += pn
    if offset != flats[0].size:
        raise ValueError(
            f"stage-3 reconstruction consumed {offset} of "
            f"{flats[0].size} elements per rank — leftover data means "
            f"param_shapes do not match this checkpoint")
    return out


def write_universal(named: Dict[str, np.ndarray], out_dir: str,
                    tag: str = "global_step0",
                    extra_meta: Optional[Dict] = None) -> str:
    tag_dir = os.path.join(out_dir, tag)
    os.makedirs(tag_dir, exist_ok=True)
    np.savez(os.path.join(tag_dir, "params.npz"), **named)
    meta = {"format": META_FORMAT,
            "n_params": len(named),
            "names": sorted(named),
            "shapes": {k: list(v.shape) for k, v in named.items()}}
    meta.update(extra_meta or {})
    with open(os.path.join(tag_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    with open(os.path.join(out_dir, "latest"), "w") as f:
        f.write(tag)
    return tag_dir


def load_universal_named(out_dir: str,
                         tag: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Read a ``universal_named`` dir back into {name: array}."""
    if tag is None:
        with open(os.path.join(out_dir, "latest")) as f:
            tag = f.read().strip()
    with np.load(os.path.join(out_dir, tag, "params.npz")) as z:
        return {k: z[k] for k in z.files}


def convert(ckpt_dir: str, out_dir: str, tag: Optional[str] = None,
            cat_dim_rules: Optional[Dict[str, int]] = None) -> str:
    """Reference tag dir (or parent with ``latest``) -> universal dir."""
    if os.path.isfile(os.path.join(ckpt_dir, "latest")):
        with open(os.path.join(ckpt_dir, "latest")) as f:
            ckpt_dir = os.path.join(ckpt_dir, f.read().strip())
    named = extract_fp32_state(ckpt_dir, cat_dim_rules=cat_dim_rules)
    return write_universal(named, out_dir,
                           tag=tag or os.path.basename(ckpt_dir.rstrip("/")),
                           extra_meta={"source": os.path.abspath(ckpt_dir)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Convert a reference (torch) checkpoint to the native "
                    "universal_named layout")
    ap.add_argument("input_dir", help="reference checkpoint dir (tag dir, "
                                      "or parent containing 'latest')")
    ap.add_argument("output_dir")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--cat-dim", action="append", default=[],
                    metavar="REGEX=DIM",
                    help="concat dim for tensor-parallel slices whose name "
                         "matches REGEX (e.g. 'dense_4h_to_h.weight=1')")
    args = ap.parse_args(argv)
    rules = {}
    for spec in args.cat_dim:
        pat, _, dim = spec.rpartition("=")
        rules[pat] = int(dim)
    tag_dir = convert(args.input_dir, args.output_dir, args.tag,
                      cat_dim_rules=rules or None)
    print(f"wrote {tag_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
