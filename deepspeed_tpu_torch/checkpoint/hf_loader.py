"""HuggingFace checkpoint loading: shards -> the port's parameter tree
(port of ``deepspeed_tpu/checkpoint/hf_loader.py``: the Llama family,
GPT-2, OPT, BLOOM, GPT-NeoX, GPT-J, Phi, Mixtral and Qwen2-MoE).

- A safetensors reader with no dependency: the format is an 8-byte
  little-endian header length, a JSON header, then the raw little-endian
  bytes of each tensor. A ``BF16`` tensor is read straight into a
  ``torch.bfloat16`` tensor (the JAX reader widens it to fp32: the same
  values in twice the memory).
- ``pytorch_model*.bin`` shards through ``torch.load(weights_only=True)``.
- The HF -> tree name map of the Llama family (llama, mistral, qwen,
  qwen2, phi3), with the ``[out, in]`` -> ``[in, out]`` transpose of the
  linear weights and the splits of phi3's fused ``qkv_proj`` /
  ``gate_up_proj`` and qwen v1's fused ``c_attn``; GPT-2's, whose
  ``Conv1D`` weights are already ``[in, out]`` and whose tied
  ``lm_head.weight`` is dropped; and the maps of OPT, Phi, BLOOM,
  GPT-NeoX and GPT-J, with BLOOM's and NeoX's fused ``query_key_value``
  split head by head (its rows are ordered (head, [q k v], D)); and
  the MoE maps of Mixtral and Qwen2-MoE, whose per-expert SwiGLU weights
  are stacked into the tree's ``[E, in, out]`` leaves on the device as
  they stream (``_ExpertStacker``). Falcon has no map, as in the JAX
  loader.

The tree has the paths of ``checkpoint/jax_params.py``
(``embed/embedding``, ``layer_i/attn/q_proj/kernel``, ...; GPT-2's
``wte/embedding``, ``h_i/attn/c_attn/kernel``, ...), which is what
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
from .jax_params import param_shapes

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

# HF's GPT-2 Conv1D weights are already [in, out]: no transpose
_GPT2_MAP = [
    (r"(?:transformer\.)?wte\.weight", "wte/embedding", "embed"),
    (r"(?:transformer\.)?wpe\.weight", "wpe/embedding", "embed"),
    (r"(?:transformer\.)?ln_f\.(weight|bias)",
     "ln_f/{w:scale,b:bias}", "vector"),
    (r"(?:transformer\.)?h\.(\d+)\.ln_(1|2)\.(weight|bias)",
     "h_{0}/ln_{1}/{w:scale,b:bias}", "vector"),
    (r"(?:transformer\.)?h\.(\d+)\.attn\.c_attn\.(weight|bias)",
     "h_{0}/attn/c_attn/{w:kernel,b:bias}", "conv1d"),
    (r"(?:transformer\.)?h\.(\d+)\.attn\.c_proj\.(weight|bias)",
     "h_{0}/attn/c_proj/{w:kernel,b:bias}", "conv1d"),
    (r"(?:transformer\.)?h\.(\d+)\.mlp\.c_fc\.(weight|bias)",
     "h_{0}/mlp/c_fc/{w:kernel,b:bias}", "conv1d"),
    (r"(?:transformer\.)?h\.(\d+)\.mlp\.c_proj\.(weight|bias)",
     "h_{0}/mlp/c_proj/{w:kernel,b:bias}", "conv1d"),
]

_OPT_MAP = [
    # .bin checkpoints carry lm_head.weight even when tied; the converter
    # drops it for tie_embeddings configs
    (r"lm_head\.weight", "lm_head/kernel", "linear"),
    (r"(?:model\.)?decoder\.embed_tokens\.weight", "embed_tokens/embedding",
     "embed"),
    (r"(?:model\.)?decoder\.embed_positions\.weight",
     "embed_positions/embedding", "embed"),
    (r"(?:model\.)?decoder\.final_layer_norm\.(weight|bias)",
     "final_layer_norm/{w:scale,b:bias}", "vector"),
    (r"(?:model\.)?decoder\.project_in\.weight", "project_in/kernel",
     "linear"),
    (r"(?:model\.)?decoder\.project_out\.weight", "project_out/kernel",
     "linear"),
    (r"(?:model\.)?decoder\.layers\.(\d+)\.self_attn\.(q|k|v|out)_proj\.weight",
     "layer_{0}/self_attn/{1}_proj/kernel", "linear"),
    (r"(?:model\.)?decoder\.layers\.(\d+)\.self_attn\.(q|k|v|out)_proj\.bias",
     "layer_{0}/self_attn/{1}_proj/bias", "vector"),
    (r"(?:model\.)?decoder\.layers\.(\d+)\.self_attn_layer_norm\.(weight|bias)",
     "layer_{0}/self_attn_layer_norm/{w:scale,b:bias}", "vector"),
    (r"(?:model\.)?decoder\.layers\.(\d+)\.final_layer_norm\.(weight|bias)",
     "layer_{0}/final_layer_norm/{w:scale,b:bias}", "vector"),
    (r"(?:model\.)?decoder\.layers\.(\d+)\.fc(1|2)\.weight",
     "layer_{0}/fc{1}/kernel", "linear"),
    (r"(?:model\.)?decoder\.layers\.(\d+)\.fc(1|2)\.bias",
     "layer_{0}/fc{1}/bias", "vector"),
]

_PHI_MAP = [
    (r"model\.embed_tokens\.weight", "embed_tokens/embedding", "embed"),
    (r"model\.final_layernorm\.(weight|bias)",
     "final_layernorm/{w:scale,b:bias}", "vector"),
    (r"lm_head\.weight", "lm_head/kernel", "linear"),
    (r"lm_head\.bias", "lm_head/bias", "vector"),
    (r"model\.layers\.(\d+)\.input_layernorm\.(weight|bias)",
     "layer_{0}/input_layernorm/{w:scale,b:bias}", "vector"),
    (r"model\.layers\.(\d+)\.self_attn\.(q|k|v)_proj\.weight",
     "layer_{0}/self_attn/{1}_proj/kernel", "linear"),
    (r"model\.layers\.(\d+)\.self_attn\.(q|k|v)_proj\.bias",
     "layer_{0}/self_attn/{1}_proj/bias", "vector"),
    (r"model\.layers\.(\d+)\.self_attn\.dense\.weight",
     "layer_{0}/self_attn/dense/kernel", "linear"),
    (r"model\.layers\.(\d+)\.self_attn\.dense\.bias",
     "layer_{0}/self_attn/dense/bias", "vector"),
    (r"model\.layers\.(\d+)\.mlp\.fc(1|2)\.weight",
     "layer_{0}/fc{1}/kernel", "linear"),
    (r"model\.layers\.(\d+)\.mlp\.fc(1|2)\.bias",
     "layer_{0}/fc{1}/bias", "vector"),
]

_BLOOM_MAP = [
    (r"lm_head\.weight", "lm_head/kernel", "linear"),   # untied variants
    (r"(?:transformer\.)?word_embeddings\.weight",
     "word_embeddings/embedding", "embed"),
    (r"(?:transformer\.)?word_embeddings_layernorm\.(weight|bias)",
     "word_embeddings_layernorm/{w:scale,b:bias}", "vector"),
    (r"(?:transformer\.)?ln_f\.(weight|bias)", "ln_f/{w:scale,b:bias}",
     "vector"),
    (r"(?:transformer\.)?h\.(\d+)\.(input|post_attention)_layernorm\.(weight|bias)",
     "layer_{0}/{1}_layernorm/{w:scale,b:bias}", "vector"),
    (r"(?:transformer\.)?h\.(\d+)\.self_attention\.(q|k|v)_proj\.weight",
     "layer_{0}/self_attention/{1}_proj/kernel", "linear"),
    (r"(?:transformer\.)?h\.(\d+)\.self_attention\.(q|k|v)_proj\.bias",
     "layer_{0}/self_attention/{1}_proj/bias", "vector"),
    (r"(?:transformer\.)?h\.(\d+)\.self_attention\.dense\.weight",
     "layer_{0}/self_attention/dense/kernel", "linear"),
    (r"(?:transformer\.)?h\.(\d+)\.self_attention\.dense\.bias",
     "layer_{0}/self_attention/dense/bias", "vector"),
    (r"(?:transformer\.)?h\.(\d+)\.mlp\.dense_(h_to_4h|4h_to_h)\.weight",
     "layer_{0}/dense_{1}/kernel", "linear"),
    (r"(?:transformer\.)?h\.(\d+)\.mlp\.dense_(h_to_4h|4h_to_h)\.bias",
     "layer_{0}/dense_{1}/bias", "vector"),
]

_NEOX_MAP = [
    (r"gpt_neox\.embed_in\.weight", "embed_in/embedding", "embed"),
    (r"gpt_neox\.final_layer_norm\.(weight|bias)",
     "final_layer_norm/{w:scale,b:bias}", "vector"),
    (r"embed_out\.weight", "embed_out/kernel", "linear"),
    (r"gpt_neox\.layers\.(\d+)\.(input|post_attention)_layernorm\.(weight|bias)",
     "layer_{0}/{1}_layernorm/{w:scale,b:bias}", "vector"),
    (r"gpt_neox\.layers\.(\d+)\.attention\.(q|k|v)_proj\.weight",
     "layer_{0}/{1}_proj/kernel", "linear"),
    (r"gpt_neox\.layers\.(\d+)\.attention\.(q|k|v)_proj\.bias",
     "layer_{0}/{1}_proj/bias", "vector"),
    (r"gpt_neox\.layers\.(\d+)\.attention\.dense\.weight",
     "layer_{0}/dense/kernel", "linear"),
    (r"gpt_neox\.layers\.(\d+)\.attention\.dense\.bias",
     "layer_{0}/dense/bias", "vector"),
    (r"gpt_neox\.layers\.(\d+)\.mlp\.dense_(h_to_4h|4h_to_h)\.weight",
     "layer_{0}/dense_{1}/kernel", "linear"),
    (r"gpt_neox\.layers\.(\d+)\.mlp\.dense_(h_to_4h|4h_to_h)\.bias",
     "layer_{0}/dense_{1}/bias", "vector"),
]

_GPTJ_MAP = [
    (r"transformer\.wte\.weight", "wte/embedding", "embed"),
    (r"transformer\.ln_f\.(weight|bias)", "ln_f/{w:scale,b:bias}", "vector"),
    (r"lm_head\.weight", "lm_head/kernel", "linear"),
    (r"lm_head\.bias", "lm_head/bias", "vector"),
    (r"transformer\.h\.(\d+)\.ln_1\.(weight|bias)",
     "layer_{0}/ln_1/{w:scale,b:bias}", "vector"),
    (r"transformer\.h\.(\d+)\.attn\.(q|k|v|out)_proj\.weight",
     "layer_{0}/{1}_proj/kernel", "linear"),
    (r"transformer\.h\.(\d+)\.mlp\.fc_(in|out)\.weight",
     "layer_{0}/fc_{1}/kernel", "linear"),
    (r"transformer\.h\.(\d+)\.mlp\.fc_(in|out)\.bias",
     "layer_{0}/fc_{1}/bias", "vector"),
]

ARCH_MAPS = {
    "gpt2": _GPT2_MAP,
    "llama": _LLAMA_MAP,
    "mistral": _LLAMA_MAP,
    "qwen": _LLAMA_MAP,    # v1: fused names split by _split_qwen_fused
    "qwen2": _LLAMA_MAP,
    "phi3": _LLAMA_MAP,    # fused names split by _split_phi3_fused
    "phi": _PHI_MAP,
    "opt": _OPT_MAP,
    "bloom": _BLOOM_MAP,   # fused qkv split by _split_headwise_qkv
    "gpt_neox": _NEOX_MAP,  # likewise
    "gptj": _GPTJ_MAP,
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


def _split_headwise_qkv(name: str, arr: torch.Tensor, hf_cfg: Dict
                        ) -> List[Tuple[str, torch.Tensor]]:
    """BLOOM's and GPT-NeoX's fused ``query_key_value`` weight or bias,
    whose rows are ordered (head, [q k v], head_dim), -> the ``q_proj`` /
    ``k_proj`` / ``v_proj`` names beside it (the reference's containers
    de-interleave the same way)."""
    m = re.match(r"(.*\.)query_key_value\.(weight|bias)$", name)
    if not m:
        return [(name, arr)]
    heads = int(hf_cfg.get("n_head", hf_cfg.get("num_attention_heads")))
    rest = tuple(arr.shape[1:])
    D = arr.shape[0] // (3 * heads)
    a = arr.reshape((heads, 3, D) + rest)
    return [(f"{m.group(1)}{w}_proj.{m.group(2)}",
             a[:, j].reshape((heads * D,) + rest))
            for j, w in enumerate("qkv")]


class _ExpertStacker:
    """Per-expert SwiGLU weights -> the tree's stacked experts, one tensor
    at a time (port of ``_stack_moe_experts``): expert ``e``'s HF ``[out,
    in]`` weight goes to the device and lands transposed in slot ``e`` of
    an ``[E, in, out]`` stack there, which is handed on as
    ``model.layers.{i}.moe_stacked.{wi_gate|wi_up|wo}`` (kind "stacked":
    no further transpose) once its E experts have arrived. Host memory
    holds one tensor at a time; a layer's stacks wait on the device.
    Built for one checkpoint: it keeps the stacks in progress."""

    expert_re = ""
    kinds: Dict[str, str] = {}
    experts_key = ""

    def __init__(self, hf_cfg: Dict, device: torch.device):
        self.rx = re.compile(self.expert_re)
        self.E = int(hf_cfg.get(self.experts_key, 8))
        self.device = device
        self.stacks: Dict[Tuple[int, str], Tuple[torch.Tensor, set]] = {}

    def __call__(self, name: str, arr: torch.Tensor, hf_cfg: Dict
                 ) -> List[Tuple[str, torch.Tensor]]:
        m = self.rx.match(name)
        if not m:
            return [(name, arr)]
        layer, e, which = int(m.group(1)), int(m.group(2)), m.group(3)
        if e >= self.E:
            raise ValueError(f"{name}: expert {e} of {self.E}")
        key = (layer, self.kinds[which])
        if key not in self.stacks:
            self.stacks[key] = (torch.empty(
                (self.E, arr.shape[1], arr.shape[0]), dtype=arr.dtype,
                device=self.device), set())
        stack, seen = self.stacks[key]
        stack[e].copy_(arr.to(self.device).t())
        seen.add(e)
        if len(seen) < self.E:
            return []
        del self.stacks[key]
        return [(f"model.layers.{layer}.moe_stacked.{key[1]}", stack)]

    def finish(self) -> None:
        if self.stacks:
            raise ValueError(
                "checkpoint lacks experts of "
                + ", ".join(f"layer {l} {k} ({len(seen)} of {self.E})"
                            for (l, k), (_, seen) in self.stacks.items()))


class _MixtralExperts(_ExpertStacker):
    expert_re = (r"model\.layers\.(\d+)\.block_sparse_moe\.experts\.(\d+)"
                 r"\.(w1|w2|w3)\.weight$")
    kinds = {"w1": "wi_gate", "w3": "wi_up", "w2": "wo"}
    experts_key = "num_local_experts"


class _Qwen2MoeExperts(_ExpertStacker):
    expert_re = (r"model\.layers\.(\d+)\.mlp\.experts\.(\d+)\."
                 r"(gate_proj|up_proj|down_proj)\.weight$")
    kinds = {"gate_proj": "wi_gate", "up_proj": "wi_up", "down_proj": "wo"}
    experts_key = "num_experts"


#: pre-conversion transforms keyed by arch: a function of one tensor
#: (fused-tensor splitting), or a class built for each checkpoint that
#: keeps state across tensors (per-expert stacking)
SPECIAL_HANDLERS = {
    "phi3": _split_phi3_fused,
    "qwen": _split_qwen_fused,
    "bloom": _split_headwise_qkv,
    "gpt_neox": _split_headwise_qkv,
    "mixtral": _MixtralExperts,
    "qwen2_moe": _Qwen2MoeExperts,
}

_MOE_STACKED_RULES = [
    (r"model\.layers\.(\d+)\.moe_stacked\.(wi_gate|wi_up|wo)",
     "layer_{0}/moe/{1}", "stacked"),
]

_MIXTRAL_MAP = _LLAMA_MAP + _MOE_STACKED_RULES + [
    (r"model\.layers\.(\d+)\.block_sparse_moe\.gate\.weight",
     "layer_{0}/moe/gate", "linear"),
]

_QWEN2_MOE_MAP = _LLAMA_MAP + _MOE_STACKED_RULES + [
    (r"model\.layers\.(\d+)\.mlp\.gate\.weight",
     "layer_{0}/moe/gate", "linear"),
    (r"model\.layers\.(\d+)\.mlp\.shared_expert\.(gate|up|down)_proj\.weight",
     "layer_{0}/shared_{1}_proj/kernel", "linear"),
    (r"model\.layers\.(\d+)\.mlp\.shared_expert_gate\.weight",
     "layer_{0}/shared_expert_gate/kernel", "linear"),
]

ARCH_MAPS["mixtral"] = _MIXTRAL_MAP
ARCH_MAPS["qwen2_moe"] = _QWEN2_MOE_MAP


def _handler(arch: str, hf_cfg: Dict, device: torch.device):
    """The arch's pre-conversion transform for one checkpoint, or None."""
    h = SPECIAL_HANDLERS.get(arch)
    return h(hf_cfg or {}, device) if isinstance(h, type) else h


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
        if (self.tied or self.arch == "gpt2") \
                and name.endswith("lm_head.weight"):
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
    whose fused tensors are split (phi3, qwen, bloom, gpt_neox) or whose
    experts are stacked (mixtral, qwen2_moe: their expert count)."""
    dev = resolve_device(device)
    conv = _Converter(arch, dev, tied)
    split = _handler(arch, hf_cfg, dev)
    for name, arr in state.items():
        for n, a in (split(name, arr, hf_cfg) if split else [(name, arr)]):
            conv.add(n, a)
    if hasattr(split, "finish"):
        split.finish()
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
    walk(param_shapes(cfg), params, ())


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
    split = _handler(arch, hf_cfg, dev)
    n = 0
    for name, arr in iter_hf_tensors(model_dir):
        n += arr.numel()
        for nm, a in (split(name, arr, hf_cfg) if split else [(name, arr)]):
            conv.add(nm, a)
    if hasattr(split, "finish"):
        split.finish()
    params = conv.finish(strict)
    if tied:
        params.pop("lm_head", None)
    _check_tree(params, cfg)
    logger.info("loaded HF checkpoint %s: arch=%s, %.1fM params", model_dir,
                arch, n / 1e6)
    return arch, cfg, params
