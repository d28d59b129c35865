"""HuggingFace checkpoint loading: shards -> the port's parameter tree
(port of ``deepspeed_tpu/checkpoint/hf_loader.py``, the Llama family).

- A safetensors reader with no dependency: the format is an 8-byte
  little-endian header length, a JSON header, then the raw little-endian
  bytes of each tensor. A ``BF16`` tensor is read straight into a
  ``torch.bfloat16`` tensor (the JAX reader widens it to fp32: the same
  values in twice the memory).
- ``pytorch_model*.bin`` shards through ``torch.load(weights_only=True)``.
- The HF -> tree name map of the Llama family (llama, mistral, qwen,
  qwen2, phi3), with the ``[out, in]`` -> ``[in, out]`` transpose of the
  linear weights and the splits of phi3's fused ``qkv_proj`` /
  ``gate_up_proj`` and qwen v1's fused ``c_attn``.

The tree has the paths of ``checkpoint/jax_params.py``
(``embed/embedding``, ``layer_i/attn/q_proj/kernel``, ...), which is what
``InferenceEngineV2`` takes. Leaves keep the shard's dtype. Shards are
read one tensor at a time and each tensor goes to ``device`` as it is
read, so a checkpoint never sits in host memory whole.

Entry points:
    state = load_hf_state_dict(model_dir)            # {hf_name: tensor}
    params = convert_hf_state(arch, state)           # the tree
    arch, cfg, params = load_hf_model(model_dir)     # all of the above
"""

from __future__ import annotations

import json
import logging
import os
import re
import struct
from typing import Any, Dict, Iterator, List, Tuple

import torch

from ..utils.device import resolve_device
from .jax_params import llama_param_shapes

logger = logging.getLogger(__name__)

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def iter_safetensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor) for each tensor of a safetensors file, read one
    at a time in file order."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        base = 8 + hlen
        metas = sorted(((n, m) for n, m in header.items()
                        if n != "__metadata__"),
                       key=lambda nm: nm[1]["data_offsets"][0])
        for name, meta in metas:
            dt = _SAFETENSORS_DTYPES.get(meta["dtype"])
            if dt is None:
                raise ValueError(f"unsupported safetensors dtype "
                                 f"{meta['dtype']}")
            start, end = meta["data_offsets"]
            raw = torch.empty(end - start, dtype=torch.uint8)
            f.seek(base + start)
            if end > start and f.readinto(memoryview(raw.numpy())) \
                    != end - start:
                raise ValueError(f"{path}: truncated tensor {name}")
            yield name, raw.view(dt).reshape(meta["shape"])


def _read_torch_bin(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


def iter_hf_tensors(model_dir: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor) over every weight shard of an HF checkpoint
    directory: all ``*.safetensors`` files in name order, else all
    ``pytorch_model*.bin`` files."""
    files = sorted(os.listdir(model_dir))
    shards = [f for f in files if f.endswith(".safetensors")]
    if shards:
        for s in shards:
            yield from iter_safetensors(os.path.join(model_dir, s))
        return
    bins = [f for f in files
            if f.endswith(".bin") and f.startswith("pytorch_model")]
    if not bins:
        raise FileNotFoundError(
            f"no .safetensors or pytorch_model*.bin shards in {model_dir}")
    for b in bins:
        yield from _read_torch_bin(os.path.join(model_dir, b)).items()


def load_hf_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """Every weight tensor of an HF checkpoint directory, on the CPU."""
    return dict(iter_hf_tensors(model_dir))


# --------------------------------------------------------------------------- #
# name mapping
# --------------------------------------------------------------------------- #

# HF-path regex -> (tree path template, kind); "linear" is transposed
# [out, in] -> [in, out]
_LLAMA_MAP = [
    (r"model\.embed_tokens\.weight", "embed/embedding", "embed"),
    (r"model\.norm\.weight", "final_norm/scale", "vector"),
    (r"lm_head\.weight", "lm_head/kernel", "linear"),
    (r"model\.layers\.(\d+)\.input_layernorm\.weight",
     "layer_{0}/input_norm/scale", "vector"),
    (r"model\.layers\.(\d+)\.post_attention_layernorm\.weight",
     "layer_{0}/post_attn_norm/scale", "vector"),
    (r"model\.layers\.(\d+)\.self_attn\.(q|k|v|o)_proj\.weight",
     "layer_{0}/attn/{1}_proj/kernel", "linear"),
    (r"model\.layers\.(\d+)\.self_attn\.(q|k|v)_proj\.bias",
     "layer_{0}/attn/{1}_proj/bias", "vector"),
    (r"model\.layers\.(\d+)\.mlp\.(gate|up|down)_proj\.weight",
     "layer_{0}/mlp/{1}_proj/kernel", "linear"),
]

ARCH_MAPS = {
    "llama": _LLAMA_MAP,
    "mistral": _LLAMA_MAP,
    "qwen": _LLAMA_MAP,    # v1: fused names split by _split_qwen_fused
    "qwen2": _LLAMA_MAP,
    "phi3": _LLAMA_MAP,    # fused names split by _split_phi3_fused
}


def _split_phi3_fused(name: str, arr: torch.Tensor, hf_cfg: Dict
                      ) -> List[Tuple[str, torch.Tensor]]:
    """Phi-3's fused ``qkv_proj`` ([H*D, KV*D, KV*D] rows) and
    ``gate_up_proj`` (two halves) -> the llama names (same math)."""
    heads = int(hf_cfg["num_attention_heads"])
    kv = int(hf_cfg.get("num_key_value_heads", heads))
    d = int(hf_cfg["hidden_size"]) // heads
    m = re.match(r"(model\.layers\.\d+\.self_attn)\.qkv_proj\.weight$", name)
    if m:
        q, k, v = torch.split(arr, [heads * d, kv * d, kv * d], dim=0)
        return [(f"{m.group(1)}.{w}_proj.weight", t)
                for w, t in zip("qkv", (q, k, v))]
    m = re.match(r"(model\.layers\.\d+\.mlp)\.gate_up_proj\.weight$", name)
    if m:
        gate, up = torch.chunk(arr, 2, dim=0)
        return [(f"{m.group(1)}.gate_proj.weight", gate),
                (f"{m.group(1)}.up_proj.weight", up)]
    return [(name, arr)]


def _split_qwen_fused(name: str, arr: torch.Tensor, hf_cfg: Dict
                      ) -> List[Tuple[str, torch.Tensor]]:
    """Qwen v1 (model_type "qwen"): the fused ``c_attn`` qkv and the
    ``w1`` / ``w2`` / ``c_proj`` SwiGLU -> the llama names. Its MLP is
    ``c_proj(w1(x) * silu(w2(x)))``: w2 is the gate, w1 the up
    projection."""
    H = int(hf_cfg["hidden_size"])
    n = name.replace("transformer.h.", "model.layers.")
    if n.endswith(".attn.c_attn.weight") or n.endswith(".attn.c_attn.bias"):
        base = n[:n.index(".attn.c_attn.")]
        leaf = name.split(".")[-1]
        return [(f"{base}.self_attn.{w}_proj.{leaf}", arr[i * H:(i + 1) * H])
                for i, w in enumerate("qkv")]
    for old, new in ((".attn.c_proj.", ".self_attn.o_proj."),
                     (".mlp.w2.", ".mlp.gate_proj."),
                     (".mlp.w1.", ".mlp.up_proj."),
                     (".mlp.c_proj.", ".mlp.down_proj."),
                     (".ln_1.", ".input_layernorm."),
                     (".ln_2.", ".post_attention_layernorm.")):
        if old in n:
            return [(n.replace(old, new), arr)]
    if name.endswith("transformer.wte.weight"):
        return [("model.embed_tokens.weight", arr)]
    if name.endswith("transformer.ln_f.weight"):
        return [("model.norm.weight", arr)]
    return [(n, arr)]                               # lm_head etc.


SPECIAL_HANDLERS = {
    "phi3": _split_phi3_fused,
    "qwen": _split_qwen_fused,
}


def _fw_path(template: str, groups: Tuple[str, ...]) -> str:
    """Expand a map template: {N} positional groups and the
    {w:scale,b:bias} weight/bias selector."""
    out = template
    for i, g in enumerate(groups):
        out = out.replace("{" + str(i) + "}", g)
    m = re.search(r"\{w:([^,]+),b:([^}]+)\}", out)
    if m:
        which = groups[-1]
        out = out[:m.start()] + (m.group(1) if which.startswith("w")
                                 else m.group(2)) + out[m.end():]
    return out


#: non-parameter tensors of real Hub checkpoints, skipped silently
_IGNORED_TENSORS = re.compile(
    r".*\.((attn|attention)\.(bias|masked_bias)|rotary_emb\.inv_freq|"
    r"embeddings\.position_ids)$")


class _Converter:
    """Maps HF tensors one at a time into the tree, each moved to
    ``device`` and transposed there."""

    def __init__(self, arch: str, device: torch.device, tied: bool):
        if arch not in ARCH_MAPS:
            raise ValueError(f"no HF name map for architecture '{arch}' "
                             f"(have {sorted(ARCH_MAPS)})")
        self.rules = [(re.compile(pat + r"$"), tmpl, kind)
                      for pat, tmpl, kind in ARCH_MAPS[arch]]
        self.arch, self.device, self.tied = arch, device, tied
        self.params: Dict[str, Any] = {}
        self.unmapped: List[str] = []

    def add(self, name: str, arr: torch.Tensor) -> None:
        if _IGNORED_TENSORS.match(name):
            return
        if self.tied and name.endswith("lm_head.weight"):
            return                       # tied duplicate of the embedding
        for rx, tmpl, kind in self.rules:
            m = rx.match(name)
            if m:
                break
        else:
            self.unmapped.append(name)
            return
        path = _fw_path(tmpl, m.groups() + (name.split(".")[-1],))
        t = arr.to(self.device)
        if kind == "linear" and t.dim() == 2:
            t = t.t()                    # torch [out, in] -> [in, out]
        node = self.params
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t.contiguous()

    def finish(self, strict: bool) -> Dict[str, Any]:
        if self.unmapped:
            u = self.unmapped
            msg = (f"{len(u)} HF tensors had no mapping for '{self.arch}': "
                   f"{u[:5]}{'...' if len(u) > 5 else ''}")
            if strict:
                raise ValueError(msg)
            logger.warning(msg)
        return self.params


def convert_hf_state(arch: str, state: Dict[str, torch.Tensor],
                     strict: bool = True, tied: bool = False,
                     hf_cfg: Dict = None, device: Any = "cpu"
                     ) -> Dict[str, Any]:
    """Map an HF state dict onto the port's nested tree. ``tied=True``
    drops a serialized ``lm_head.weight`` (tie_word_embeddings models
    unembed through the embedding). ``hf_cfg`` is needed for the archs
    whose fused tensors are split (phi3, qwen)."""
    conv = _Converter(arch, resolve_device(device), tied)
    split = SPECIAL_HANDLERS.get(arch)
    for name, arr in state.items():
        for n, a in (split(name, arr, hf_cfg) if split else [(name, arr)]):
            conv.add(n, a)
    return conv.finish(strict)


def _check_tree(params: Dict[str, Any], cfg) -> None:
    """Every leaf the runner reads is there with its shape."""

    def walk(shapes, node, path):
        for k, v in shapes.items():
            p = path + (k,)
            if k not in node:
                raise ValueError(f"checkpoint lacks {'/'.join(p)}")
            if isinstance(v, dict):
                walk(v, node[k], p)
            elif tuple(node[k].shape) != tuple(v):
                raise ValueError(f"{'/'.join(p)}: shape "
                                 f"{tuple(node[k].shape)} != expected {v}")
    walk(llama_param_shapes(cfg), params, ())


def load_hf_model(model_dir: str, strict: bool = True, device: Any = None):
    """(arch, model_config, params) from an HF checkpoint directory, the
    tensors on ``device`` (default ``cuda``). ``config.json`` is read and
    checked before any shard."""
    from ..models.registry import config_from_hf
    dev = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        hf_cfg = json.load(f)
    arch, cfg = config_from_hf(hf_cfg)
    tied = bool(getattr(cfg, "tie_embeddings", False))
    conv = _Converter(arch, dev, tied)       # fails before any shard
    split = SPECIAL_HANDLERS.get(arch)
    n = 0
    for name, arr in iter_hf_tensors(model_dir):
        n += arr.numel()
        for nm, a in (split(name, arr, hf_cfg) if split else [(name, arr)]):
            conv.add(nm, a)
    params = conv.finish(strict)
    if tied:
        params.pop("lm_head", None)
    _check_tree(params, cfg)
    logger.info("loaded HF checkpoint %s: arch=%s, %.1fM params", model_dir,
                arch, n / 1e6)
    return arch, cfg, params
