"""Model configuration: HF config.json parsing and architecture dispatch
(counterpart of exllamav3_tpu/model/config.py)."""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

from ..loader.safetensors import SafetensorsCollection
from ..util.rope import RopeSettings, RopeStyle


class _NoDefault:
    pass


no_default = _NoDefault()


@dataclass
class InferParams:
    """Runtime tunables."""

    # EXL3 linear runtime representation: "auto" | "int8" | "int6" | "int5" | "int4" | "int3"
    # | "bf16" | "reconstruct" | "fused"
    linear_mode: str = "auto"
    # fuse q/k/v and gate/up into single matmuls at load
    fuse_projections: bool = True


class Config:
    arch_string: str | None = None

    def __init__(self, directory: str, model_classes: dict, **kwargs):
        self.directory = directory
        self.model_classes = model_classes
        self.infer_params = kwargs.get("infer_params") or InferParams()
        with open(os.path.join(directory, "config.json"), "r") as f:
            self.cfg = json.load(f)
        self.stc = SafetensorsCollection(directory)

        self.architectures = self.cfg.get("architectures", [])
        self.bos_token_id = self.read_cfg((int, list), "bos_token_id", None)
        self.eos_token_id = self.read_cfg((int, list), "eos_token_id", None)
        self.vocab_size = self.read_cfg(int, "vocab_size", no_default)
        self.hidden_size = self.read_cfg(int, "hidden_size", no_default)
        self.max_position_embeddings = self.read_cfg(int, "max_position_embeddings", 4096)

    # -- config readers --------------------------------------------------

    def _walk(self, keys):
        """keys: 'a.b.c' path or list of fallbacks; keys missing at the top
        level fall back to text_config.<key>."""
        keys = [keys] if isinstance(keys, str) else list(keys)
        if isinstance(self.cfg.get("text_config"), dict):
            keys = keys + [f"text_config.{k}" for k in keys
                           if not k.startswith("text_config")]
        for key in keys:
            node = self.cfg
            ok = True
            for part in key.replace("->", ".").split("."):
                if isinstance(node, dict) and part in node:
                    node = node[part]
                else:
                    ok = False
                    break
            if ok and node is not None:
                return node
        return None

    def read_cfg(self, types, keys, default):
        v = self._walk(keys)
        if v is None:
            if isinstance(default, _NoDefault):
                raise ValueError(f"missing config key: {keys} in {self.directory}")
            return default
        if types is bool and isinstance(v, bool):
            return v
        if types is int and isinstance(v, bool):
            raise ValueError(f"config key {keys}: bool where int expected")
        if types in (int, float) and isinstance(v, (int, float)):
            return types(v)
        return v

    def assert_cfg(self, types, keys, value, optional: bool = False):
        v = self._walk(keys)
        if v is None and optional:
            return
        if v != value:
            raise ValueError(f"unsupported config: {keys} = {v!r}, expected {value!r}")

    def read_rope_settings_default(self, style: RopeStyle, head_dim: int | None = None,
                                   default_theta: float = 10000.0) -> RopeSettings:
        head_dim = head_dim or getattr(self, "head_dim", None) or (
            self.hidden_size // self.read_cfg(int, "num_attention_heads", 1))
        return RopeSettings(
            head_dim=head_dim,
            rope_theta=self.read_cfg(float, "rope_theta", default_theta),
            rope_scaling=self.read_cfg(dict, "rope_scaling", None),
            rotary_dim=self.read_cfg(int, "rotary_dim", None),
            partial_rotary_factor=self.read_cfg(float, "partial_rotary_factor", 1.0),
            max_position_embeddings=self.max_position_embeddings,
            original_max_position_embeddings=self.read_cfg(
                int, "original_max_position_embeddings", None),
            rope_style=style,
        )

    # -- factory ----------------------------------------------------------

    @staticmethod
    def from_directory(directory: str, **kwargs) -> "Config":
        from ..architectures import get_architectures

        with open(os.path.join(directory, "config.json"), "r") as f:
            archs = json.load(f).get("architectures") or []
        registry = get_architectures()
        for arch in archs:
            if arch in registry:
                return registry[arch]["config_class"](directory, **kwargs)
        raise ValueError(f"unsupported architecture(s): {archs}")
