"""The plain reference: the configured models in float32 PyTorch.

Written from the published description of each family, with the port's
stated conventions (which the configuration files list under `assumed`):

  - RMSNorm with a scale of 1 + w, computed in float32
  - RoPE on split halves, float32 angles, theta from the configuration,
    applied to q and k (MLA: to the rope parts) at each token's position
  - GQA attention with softmax scale dh^-1/2; MLA not absorbed: K and V
    expanded per head from the latent rows, scale (nope + rope)^-1/2
  - SwiGLU feed-forwards; MoE: softmax router, top-k (ties to the lower
    index), gates renormalised over the k, GShard capacity
    max(4, cf k T / E) per expert over the T tokens of one step in
    token order (an assignment past it is dropped), shared experts added
  - the logits of a decode step's token over the whole padded vocabulary

Every product and reduction runs in float32 with TF32 off, layer by layer
and item by item. `precision="fp8"` is the control: every product's
operands, and the cached rows, rounded to float8 e4m3 (weights with one
scale per tensor, activations and cache rows with one per row), the rest
as in float32. It imports nothing of the program; inputs come from the
benchmark (`stretto_bench.inputs`), which makes them from the seed.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

FP8_MAX = 448.0
NEG_INF = float("-inf")


def tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 with one scale per row (last axis)."""
    s = x.abs().amax(-1, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def fp8_tensor(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 with one scale for the whole tensor."""
    s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Reference:
    """One configuration's plain forward. `params`: the benchmark's
    nested dict of weights (any float type); `model`: the configuration
    file's keys."""

    def __init__(self, model: dict, params: dict, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.m = model
        self.p = params
        self.fp8 = precision == "fp8"
        self.d = int(model["hidden_size"])
        self.H = int(model["num_attention_heads"])
        self.L = int(model["num_hidden_layers"])
        self.eps = float(model["rms_norm_eps"])
        self.theta = float(model["rope_theta"])
        self.mla = "kv_lora_rank" in model
        if self.mla:
            self.r = int(model["kv_lora_rank"])
            self.nope = int(model["qk_nope_head_dim"])
            self.rope_d = int(model["qk_rope_head_dim"])
            self.dv = int(model["v_head_dim"])
        else:
            self.KV = int(model["num_key_value_heads"])
            self.dh = int(model.get("head_dim") or self.d // self.H)
        self.E = int(model.get("n_routed_experts") or 0)
        if self.E:
            self.k = int(model["num_experts_per_tok"])
            self.cf = float(model["assumed"]["capacity_factor"])
            if not model.get("norm_topk_prob"):
                raise ValueError("gates without renormalisation are not "
                                 "what the port computes")
        tf32_off()

    # ------------------------------------------------------------ pieces
    def w(self, *path, layer: Optional[int] = None) -> torch.Tensor:
        t = self.p
        for k in path:
            t = t[k]
        t = (t if layer is None else t[layer]).float()
        return fp8_tensor(t) if self.fp8 and t.dim() >= 2 else t

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_rows(x) if self.fp8 else x

    def lin(self, x, w):
        return self.act(x) @ w

    def norm(self, x, scale):
        x = x.float()
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) \
            * (1.0 + scale.float())

    def rope(self, x, pos):
        """x (..., heads, dr) at positions pos (...,), split halves."""
        dr = x.shape[-1]
        freqs = 1.0 / (self.theta ** (torch.arange(
            0, dr, 2, dtype=torch.float32, device=x.device) / dr))
        ang = pos.float()[..., None] * freqs
        cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
        x1, x2 = x[..., :dr // 2], x[..., dr // 2:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def ffn(self, i: int, h: torch.Tensor, T: int) -> torch.Tensor:
        """The feed-forward of h (N, d), the tokens of N // T steps of T
        tokens each, one after another (MoE capacity is per step)."""
        def swiglu(x, g, u, dn):
            a = self.lin(x, g)
            return self.lin(torch.nn.functional.silu(a) * self.lin(x, u), dn)
        if not self.E:
            return swiglu(h, self.w("layers", "mlp", "w_gate", layer=i),
                          self.w("layers", "mlp", "w_up", layer=i),
                          self.w("layers", "mlp", "w_down", layer=i))
        N = h.shape[0]
        logits = self.lin(h, self.w("layers", "mlp", "router", layer=i))
        probs = torch.softmax(logits, -1)
        order = torch.sort(probs, dim=-1, descending=True, stable=True)
        vals, idx = order.values[:, :self.k], order.indices[:, :self.k]
        gates = vals / vals.sum(-1, keepdim=True)
        cap = min(int(max(4, self.cf * self.k * T / self.E)), T)
        keep = torch.zeros_like(gates, dtype=torch.bool)
        for s in range(0, N, T):                 # capacity, step by step
            counts = [0] * self.E
            for t, row in enumerate(idx[s:s + T].tolist()):
                for j, e in enumerate(row):
                    if counts[e] < cap:
                        keep[s + t, j] = True
                        counts[e] += 1
        y = torch.zeros_like(h)
        ex = self.p["layers"]["mlp"]["experts"]

        def expert(name, e):
            t = ex[name][i][e].float()
            return fp8_tensor(t) if self.fp8 else t
        for e in range(self.E):
            tok, slot = torch.nonzero((idx == e) & keep, as_tuple=True)
            if tok.numel() == 0:
                continue
            out = swiglu(h[tok], expert("w_gate", e), expert("w_up", e),
                         expert("w_down", e))
            y.index_add_(0, tok, out * gates[tok, slot][:, None])
        if "shared" in self.p["layers"]["mlp"]:
            sh = ("layers", "mlp", "shared")
            y = y + swiglu(h, self.w(*sh, "w_gate", layer=i),
                           self.w(*sh, "w_up", layer=i),
                           self.w(*sh, "w_down", layer=i))
        return y

    def head(self, x):
        x = self.norm(x, self.w("final_norm"))
        return self.lin(x, self.w("head"))

    def embed(self, tokens):
        return self.p["embed"][tokens].float()

    # ------------------------------------------------------------ decode
    def decode(self, cache: Dict[str, torch.Tensor], lengths: Sequence[int],
               tokens: torch.Tensor) -> torch.Tensor:
        """Logits (F, B, V) of F independent decode steps over the same
        cache: step f feeds tokens[f] (B,) at each item's position
        lengths[b], attending to the item's first lengths[b] cached rows
        and to its own new row."""
        F, B = tokens.shape
        dev = tokens.device
        pos = torch.tensor([int(n) for n in lengths], device=dev)
        x = self.embed(tokens)                                  # (F, B, d)
        for i in range(self.L):
            h = self.norm(x, self.w("layers", "norm_attn", layer=i))
            att = self._mla_decode(i, h, cache, lengths, pos) if self.mla \
                else self._gqa_decode(i, h, cache, lengths, pos)
            x = x + self.lin(att, self.w("layers", "attn", "wo", layer=i))
            h2 = self.norm(x, self.w("layers", "norm_mlp", layer=i))
            x = x + self.ffn(i, h2.reshape(F * B, -1), B).reshape(F, B, -1)
        return self.head(x)

    def _rows(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        return fp8_rows(t) if self.fp8 else t

    def _gqa_decode(self, i, h, cache, lengths, pos):
        F, B, _ = h.shape
        H, KV, dh = self.H, self.KV, self.dh
        G = H // KV
        a = ("layers", "attn")
        q = self.rope(self.lin(h, self.w(*a, "wq", layer=i))
                      .reshape(F, B, H, dh), pos)
        kn = self.rope(self.lin(h, self.w(*a, "wk", layer=i))
                       .reshape(F, B, KV, dh), pos)
        vn = self.lin(h, self.w(*a, "wv", layer=i)).reshape(F, B, KV, dh)
        if self.fp8:
            q, kn, vn = fp8_rows(q), fp8_rows(kn), fp8_rows(vn)
        out = torch.empty(F, B, H, dh, device=h.device)
        scale = dh ** -0.5
        for b, n in enumerate(lengths):
            n = int(n)
            K = self._rows(cache["k"][i, b, :n])               # (n, KV, dh)
            V = self._rows(cache["v"][i, b, :n])
            qb = q[:, b].reshape(F, KV, G, dh)
            s_old = torch.einsum("fkgd,nkd->fkgn", qb, K) * scale
            s_new = torch.einsum("fkgd,fkd->fkg", qb, kn[:, b]) * scale
            pr = torch.softmax(torch.cat([s_old, s_new[..., None]], -1), -1)
            o = torch.einsum("fkgn,nkd->fkgd", pr[..., :n], V) \
                + pr[..., n:] * vn[:, b][:, :, None, :]
            out[:, b] = o.reshape(F, H, dh)
        return out.reshape(F, B, H * dh)

    def _mla_decode(self, i, h, cache, lengths, pos):
        F, B, _ = h.shape
        H, r, nope, rd, dv = self.H, self.r, self.nope, self.rope_d, self.dv
        a = ("layers", "attn")
        q = self.lin(h, self.w(*a, "wq", layer=i)).reshape(F, B, H, nope + rd)
        q_nope, q_rope = q[..., :nope], self.rope(q[..., nope:], pos)
        lat = self.lin(h, self.w(*a, "w_kv_a", layer=i))
        c_new = self.norm(lat[..., :r], self.w(*a, "kv_norm", layer=i))
        kr_new = self.rope(lat[..., None, r:], pos)[..., 0, :]   # (F, B, rd)
        w_kv_b = self.w(*a, "w_kv_b", layer=i).reshape(r, H, nope + dv)
        if self.fp8:
            q_nope, q_rope = fp8_rows(q_nope), fp8_rows(q_rope)
            c_new, kr_new = fp8_rows(c_new), fp8_rows(kr_new)
        kv_new = torch.einsum("fbr,rhe->fbhe", c_new, w_kv_b)
        out = torch.empty(F, B, H, dv, device=h.device)
        scale = (nope + rd) ** -0.5
        for b, n in enumerate(lengths):
            n = int(n)
            C = self._rows(cache["c_kv"][i, b, :n])             # (n, r)
            KR = self._rows(cache["k_rope"][i, b, :n])          # (n, rd)
            kv = torch.einsum("nr,rhe->nhe", C, w_kv_b)
            if self.fp8:
                kv = fp8_rows(kv)
            kn, vv = kv[..., :nope], kv[..., nope:]
            s_old = (torch.einsum("fhd,nhd->fhn", q_nope[:, b], kn)
                     + torch.einsum("fhd,nd->fhn", q_rope[:, b], KR)) * scale
            knew = kv_new[:, b]
            s_new = ((q_nope[:, b] * knew[..., :nope]).sum(-1)
                     + (q_rope[:, b] * kr_new[:, b][:, None, :]).sum(-1)) \
                * scale
            pr = torch.softmax(torch.cat([s_old, s_new[..., None]], -1), -1)
            out[:, b] = torch.einsum("fhn,nhd->fhd", pr[..., :n], vv) \
                + pr[..., n:] * knew[..., nope:]
        return out.reshape(F, B, H * dv)

    # ----------------------------------------------------------- prefill
    def prefill(self, tokens: torch.Tensor, block: int = 1024):
        """One item's prompt tokens (n,): (last-position logits (V,),
        K (L, n, KV, dh) after RoPE, V (L, n, KV, dh)). GQA with a dense
        feed-forward; causal attention in query blocks."""
        if self.mla or self.E:
            raise NotImplementedError("the reference prefills GQA models "
                                      "with dense feed-forwards")
        n = tokens.shape[0]
        H, KV, dh = self.H, self.KV, self.dh
        G = H // KV
        dev = tokens.device
        pos = torch.arange(n, device=dev)
        x = self.embed(tokens)                                  # (n, d)
        Ks = torch.empty(self.L, n, KV, dh, device=dev)
        Vs = torch.empty(self.L, n, KV, dh, device=dev)
        a = ("layers", "attn")
        scale = dh ** -0.5
        for i in range(self.L):
            h = self.norm(x, self.w("layers", "norm_attn", layer=i))
            q = self.rope(self.lin(h, self.w(*a, "wq", layer=i))
                          .reshape(n, H, dh), pos)
            k = self.rope(self.lin(h, self.w(*a, "wk", layer=i))
                          .reshape(n, KV, dh), pos)
            v = self.lin(h, self.w(*a, "wv", layer=i)).reshape(n, KV, dh)
            Ks[i], Vs[i] = k, v
            if self.fp8:
                q, k, v = fp8_rows(q), fp8_rows(k), fp8_rows(v)
            att = torch.empty(n, KV, G, dh, device=dev)
            qg = q.reshape(n, KV, G, dh)
            for s in range(0, n, block):
                e = min(n, s + block)
                sc = torch.einsum("qkgd,nkd->kgqn", qg[s:e], k[:e]) * scale
                mask = torch.arange(e, device=dev)[None, :] \
                    > torch.arange(s, e, device=dev)[:, None]
                sc = sc.masked_fill(mask, NEG_INF)
                att[s:e] = torch.einsum("kgqn,nkd->qkgd",
                                        torch.softmax(sc, -1), v[:e])
            x = x + self.lin(att.reshape(n, H * dh),
                             self.w(*a, "wo", layer=i))
            h2 = self.norm(x, self.w("layers", "norm_mlp", layer=i))
            x = x + self.ffn(i, h2, n)
        return self.head(x[n - 1]), Ks, Vs

    def keep_scores(self, K: torch.Tensor, mu: torch.Tensor,
                    sig2: torch.Tensor) -> torch.Tensor:
        """Expected-Attention keep-scores (L, n) of cached keys K
        (L, n, KV, dk) against query Gaussians mu, sig2 (L, KV, G, dk):
        mean over heads and g of (k . mu) / sqrt(dk) + 0.5 (k * k) . sig2
        / dk."""
        dk = K.shape[-1]
        K = self._rows(K)
        mu, sig2 = mu.float(), sig2.float()
        if self.fp8:
            mu, sig2 = fp8_rows(mu), fp8_rows(sig2)
        lin = torch.einsum("lnkd,lkgd->lnkg", K, mu) * dk ** -0.5
        quad = torch.einsum("lnkd,lkgd->lnkg", K * K, sig2) * (0.5 / dk)
        return (lin + quad).mean(dim=(-1, -2))
