"""Block-sparse (mixture-of-experts) MLP
(counterpart of exllamav3_tpu/modules/block_sparse_mlp.py).

Expert weights are stacked bf16 tensors, (E, h, i) for gate and up and
(E, i, h) for down, built at load as the JAX package builds them: each
expert Linear loads in the model's linear mode and is read back in f32
(`Linear.get_weight_f32`), so in int8 mode a stack holds the dequantized
int8 requant rounded to bf16, in `bf16`, `fused` or `reconstruct` mode the
trellis reconstruction. Experts load one at a time, and one layer's stacks
are built at a time.

Routing: "std" (softmax, top-k, optional renormalization; Mixtral,
Qwen3-MoE; "std_norm", DeepSeek-V1's name, is the same), "sigmoid",
"std_bias" (top-k of the biased logits, softmax over the selected), "ds3"
(sigmoid scores + correction bias choose the experts, group-limited; the
unbiased scores weight them), "sqrtsp" (DeepSeek-V4: sqrt(softplus)
affinity, the bias for the selection only, weights normalized over the
selection) and "group_greedy". DeepSeek-V4's first `num_hash_layers` route by
token id (`key_tid2eid`): a frozen (vocab, k) table picks the experts and the
sqrtsp affinity weights them; the ids come in ForwardCtx.input_ids. Top-k
breaks ties toward the lower expert index, as `jax.lax.top_k` does, on both
devices.

The routed compute takes one of three bodies, chosen as the JAX package
chooses them, with T all rows of the step:
  * grouped: T * k * 2 < T * E and T >= 16 (prefill): the assignments sorted
    by expert and one product per expert that received tokens (the JAX
    package's `ragged_dot` is an XLA product outside any Pallas kernel);
  * selected: T <= 16 and the shapes the kernel takes (decode): the
    selected-expert kernel (ops/moe_gemm.py) reads only the routed experts;
  * dense-all: every expert, plain PyTorch (EXL3_TPU_MOE=dense, and shapes
    neither of the others take).
Shared experts (DeepSeek) are a dense GatedMLP on the same input whose
output adds to the routed one in f32. `act_clamp` L (DeepSeek-V4's
swiglu_limit) makes every body's activation min(silu(g), L) * clip(u, -L, L).
Expert parallelism, host offload, gpt-oss split / MXFP4 experts, the shared
experts' gate, Gemma4's residual routing and norms, per-expert scales,
non-gated experts and the silu_oai activation are not ported yet.
"""
from __future__ import annotations

import torch

from .linear import Linear
from .module import ForwardCtx, Module
from ..ops.moe_gemm import _pick_bi, selected_expert_mlp, silu_mul
from ..util.env import moe_backend


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis; equal
    values in ascending index order, as `jax.lax.top_k` gives them."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


class BlockSparseMLP(Module):
    def __init__(self, config, key: str, hidden_size: int, intermediate_size: int,
                 num_experts: int, num_experts_per_tok: int, key_up: str = "up_proj",
                 key_gate: str = "gate_proj", key_down: str = "down_proj",
                 key_routing_gate: str = "gate", key_expert: str = "experts.{expert_idx}",
                 key_e_score_bias: str | None = None, activation: str = "silu",
                 routing: str = "std", norm_topk_prob: bool = True, n_group: int = 1,
                 topk_group: int = 1, routed_scaling_factor: float = 1.0, gated: bool = True,
                 act_clamp: float = 0.0, key_tid2eid: str | None = None,
                 shared_experts: Module | None = None, out_dtype=None, **unported):
        super().__init__(config, key)
        named = sorted(n for n, v in unported.items() if v)
        if named:
            raise NotImplementedError(f"BlockSparseMLP: {', '.join(named)} not ported yet")
        if not gated or activation != "silu":
            raise NotImplementedError("BlockSparseMLP: only gated silu experts are ported")
        if routing not in ("std", "std_norm", "sigmoid", "std_bias", "ds3", "sqrtsp",
                           "group_greedy"):
            raise ValueError(f"unknown routing {routing!r}")
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_experts = num_experts
        self.top_k = num_experts_per_tok
        self.activation = activation
        self.act_clamp = act_clamp
        self.key_tid2eid = key_tid2eid
        self.routing = routing
        self.norm_topk_prob = norm_topk_prob
        self.n_group = n_group
        self.topk_group = topk_group
        self.routed_scaling_factor = routed_scaling_factor
        self.out_dtype = out_dtype
        self.key_e_score_bias = key_e_score_bias
        self.keys_gud = (key_gate, key_up, key_down)
        self.router = Linear(config, f"{key}.{key_routing_gate}", hidden_size, num_experts)
        self.shared_experts = shared_experts
        self.modules = [self.router] + ([shared_experts] if shared_experts is not None else [])
        # expert Linears exist as loaders only; forward uses the stacked params
        shapes = {key_gate: (hidden_size, intermediate_size),
                  key_up: (hidden_size, intermediate_size),
                  key_down: (intermediate_size, hidden_size)}
        self.expert_linears = {
            name: [Linear(config, f"{key}.{key_expert.format(expert_idx=e)}.{name}", *shape)
                   for e in range(num_experts)]
            for name, shape in shapes.items()}

    # -- loading -----------------------------------------------------------------

    def load(self, params: dict, device: torch.device) -> None:
        self.router.load(params, device)
        if self.shared_experts is not None:
            self.shared_experts.load(params, device)
        # DeepSeek-V3 noaux_tc expert-choice correction bias: it shifts the
        # selection scores only, never the routing weights
        eb_key = (f"{self.key}.{self.key_e_score_bias}" if self.key_e_score_bias
                  else self.router.key + ".e_score_correction_bias")
        eb = self.config.stc.get_tensor(eb_key, optional=True)
        if eb is not None:
            params[self.router.key]["e_bias"] = eb.to(device=device, dtype=torch.float32)
            if eb_key == self.router.key + ".bias":
                params[self.router.key].pop("bias", None)
        params[self.key] = {"w_" + name: self._stack(lins, device)
                            for name, lins in self.expert_linears.items()}
        self.load_tid2eid(params, device)

    def load_tid2eid(self, params: dict, device: torch.device) -> None:
        """The hash-routing table (vocab, k) int32, where the checkpoint has
        one for this layer."""
        if self.key_tid2eid:
            t2e = self.config.stc.get_tensor(f"{self.key}.{self.key_tid2eid}", optional=True)
            if t2e is not None:
                params[self.key]["tid2eid"] = t2e.to(device=device, dtype=torch.long)

    def _stack(self, lins: list, device: torch.device) -> torch.Tensor:
        """(E, in, out) bf16: every expert's `get_weight_f32` after a load in
        the model's linear mode, each expert's params freed once read back."""
        out = torch.empty((len(lins), lins[0].in_features, lins[0].out_features),
                          dtype=torch.bfloat16, device=device)
        for e, lin in enumerate(lins):
            tmp: dict = {}
            lin.load(tmp, device)
            out[e] = lin.get_weight_f32(tmp).to(torch.bfloat16)
            del tmp
        return out

    # -- routing -----------------------------------------------------------------

    def _group_limit(self, choice: torch.Tensor, group_score_fn) -> torch.Tensor:
        """Mask expert scores outside the topk_group best groups."""
        T, E = choice.shape
        g = choice.reshape(T, self.n_group, E // self.n_group)
        _, top_groups = top_k(group_score_fn(g), self.topk_group)
        gmask = torch.zeros((T, self.n_group), dtype=torch.bool, device=choice.device)
        gmask.scatter_(1, top_groups, True)
        emask = gmask[:, :, None].expand(g.shape).reshape(T, E)
        return torch.where(emask, choice, torch.full_like(choice, -torch.inf))

    def _normalize(self, topv: torch.Tensor) -> torch.Tensor:
        return topv / (topv.sum(dim=-1, keepdim=True) + 1e-20)

    def route(self, logits: torch.Tensor, e_bias: torch.Tensor | None = None) -> torch.Tensor:
        """logits (T, E) f32 -> weights (T, E) f32, zero off the top k."""
        T, E = logits.shape
        k = self.top_k
        bias = e_bias if e_bias is not None else 0.0
        if self.routing == "std_bias":
            topv, topi = top_k(logits, k)
            topv = torch.softmax(topv, dim=-1)
        elif self.routing == "ds3":
            scores = torch.sigmoid(logits)
            choice = scores + bias
            if self.n_group > 1:
                # a group's score: the sum of its two best biased scores
                choice = self._group_limit(choice, lambda g: top_k(g, 2)[0].sum(dim=-1))
            _, topi = top_k(choice, k)
            topv = scores.gather(-1, topi)
            if self.norm_topk_prob:
                topv = self._normalize(topv)
            topv = topv * self.routed_scaling_factor
        elif self.routing == "sqrtsp":
            scores = torch.sqrt(torch.nn.functional.softplus(logits))
            _, topi = top_k(scores + bias, k)
            topv = self._normalize(scores.gather(-1, topi)) * self.routed_scaling_factor
        elif self.routing == "group_greedy":
            scores = torch.softmax(logits, dim=-1)
            choice = scores
            if self.n_group > 1:
                choice = self._group_limit(choice, lambda g: g.amax(dim=-1))
            _, topi = top_k(choice, k)
            topv = scores.gather(-1, topi)
            if self.norm_topk_prob:
                topv = self._normalize(topv)
            topv = topv * self.routed_scaling_factor
        else:
            scores = (torch.sigmoid(logits) if self.routing == "sigmoid"
                      else torch.softmax(logits, dim=-1))
            topv, topi = top_k(scores, k)
            if self.norm_topk_prob:
                topv = self._normalize(topv)
        return torch.zeros((T, E), dtype=torch.float32, device=logits.device).scatter(
            1, topi, topv.to(torch.float32))

    def route_hash(self, logits: torch.Tensor, topi: torch.Tensor) -> torch.Tensor:
        """Hash routing: the table's experts topi (T, k), weighted by the
        sqrtsp affinity normalized over them -> (T, E) f32."""
        scores = torch.sqrt(torch.nn.functional.softplus(logits))
        topv = self._normalize(scores.gather(-1, topi)) * self.routed_scaling_factor
        return torch.zeros_like(logits).scatter(1, topi, topv)

    # -- forward -----------------------------------------------------------------

    def forward(self, x, params: dict, ctx: ForwardCtx):
        p = params[self.key]
        shape = x.shape
        h = shape[-1]
        xt = x.reshape(-1, h)
        T = xt.shape[0]
        logits = self.router.forward(xt, params, ctx).to(torch.float32)
        if "tid2eid" in p and ctx.input_ids is not None:
            weights = self.route_hash(logits, p["tid2eid"][ctx.input_ids.reshape(-1).long()])
        else:
            weights = self.route(logits, params[self.router.key].get("e_bias"))
        if T * self.top_k * 2 < T * self.num_experts and T >= 16:
            out = self._grouped_experts(xt, weights, p)
        elif self._use_selected_kernel(T):
            out = self._selected_experts(xt, weights, p)
        else:
            out = self._dense_all_experts(xt, weights, p)
        if self.shared_experts is not None:
            out = out + self.shared_experts.forward(xt, params, ctx).to(torch.float32)
        out = out.reshape(*shape[:-1], h)
        return out.to(self.out_dtype or x.dtype)

    def _use_selected_kernel(self, T: int) -> bool:
        return (moe_backend() != "dense" and T <= 16
                and self.top_k < self.num_experts
                and self.hidden_size % 128 == 0
                and _pick_bi(self.hidden_size, self.intermediate_size) > 0)

    def _weights(self, p: dict):
        gk, uk, dk = self.keys_gud
        return p["w_" + gk], p["w_" + uk], p["w_" + dk]

    def _selected_experts(self, xt, weights, p):
        """Decode: the selected-expert kernel reads only the routed experts."""
        wg, wu, wd = self._weights(p)
        topv, topi = top_k(weights, self.top_k)
        return selected_expert_mlp(xt, topi, topv, wu, wd, wg=wg, act_clamp=self.act_clamp)

    def _grouped_experts(self, xt, weights, p):
        """Prefill: the (token, slot) assignments sorted by expert, one product
        per expert that received rows (k/E of the dense-all products), every
        assignment computed exactly once. The group sizes come to the host
        once per call. Each token's k results add in slot order."""
        wg, wu, wd = self._weights(p)
        T, E = weights.shape
        k = self.top_k
        topv, topi = top_k(weights, k)
        flat_e = topi.reshape(-1)
        order = torch.sort(flat_e, stable=True).indices
        t_sorted = torch.div(order, k, rounding_mode="floor")
        counts = torch.bincount(flat_e, minlength=E).tolist()
        xs = xt[t_sorted].to(torch.bfloat16)
        g = _segment_products(xs, wg, counts)
        u = _segment_products(xs, wu, counts)
        a = silu_mul(g, u, self.act_clamp).to(torch.bfloat16)
        y = _segment_products(a, wd, counts) * topv.reshape(-1)[order, None]
        per_slot = torch.empty_like(y)
        per_slot[order] = y
        return per_slot.reshape(T, k, -1).sum(dim=1)

    def _dense_all_experts(self, xt, weights, p):
        """Every expert on every row, in f32; the weights zero the unrouted."""
        wg, wu, wd = self._weights(p)
        xb = xt.to(torch.bfloat16).float()
        g = torch.einsum("th,ehi->eti", xb, wg.float())
        u = torch.einsum("th,ehi->eti", xb, wu.float())
        a = silu_mul(g, u, self.act_clamp).to(torch.bfloat16).float()
        y = torch.einsum("eti,eih->eth", a, wd.float())
        return torch.einsum("eth,te->th", y, weights)


def _segment_products(xs: torch.Tensor, w: torch.Tensor, counts: list) -> torch.Tensor:
    """Rows sorted by expert: segment e (counts[e] rows) times w[e]. bf16
    values, f32 products and result, as `ragged_dot` with an f32
    preferred_element_type gives them: the operands widen to f32 (exact), and
    an f32 product runs without TF32 on CUDA unless the caller allows it."""
    xs = xs.float()
    out = torch.empty((xs.shape[0], w.shape[-1]), device=xs.device, dtype=torch.float32)
    s = 0
    for e, c in enumerate(counts):
        if c:
            torch.matmul(xs[s:s + c], w[e].float(), out=out[s:s + c])
            s += c
    return out
