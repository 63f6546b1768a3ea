"""The plain reference of the GPT-2 decoder, written from its description
alone (pre-LN blocks, learned positions, causal softmax attention, tanh
GELU, LayerNorm with the fast variance E[x^2] - E[x]^2 clipped at 0 and
the configuration's eps, dense kernels stored (in, out)), with the
program's departures from GPT-2 (no bias on qkv and proj, an untied head).

It computes in float32 with TF32 off. ``mode="fp8"`` is the control: every
matrix product's two operands rounded to float8 (e4m3, one scale a
tensor) in the forward, the gradient passed straight through. It imports
nothing of the program: weights and tokens come from the benchmark.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.precision import fp8


def _mm(a, b, mode: str):
    if mode == "fp8":
        a, b = fp8(a), fp8(b)
    return a @ b


def layer_norm(x, scale, bias, eps: float):
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def forward(w: Dict[str, torch.Tensor], tokens: torch.Tensor, model: dict,
            mode: str = "fp32") -> torch.Tensor:
    """(B, L) int tokens -> (B, L, V) float32 logits."""
    b, l = tokens.shape
    h, d = model["num_heads"], model["d_model"]
    hd, eps = d // h, model["ln_eps"]
    x = w["tok_emb.weight"][tokens] + w["pos_emb.weight"][:l][None]
    causal = torch.ones(l, l, dtype=torch.bool, device=tokens.device).tril()
    for i in range(model["num_layers"]):
        p = f"blocks.{i}."
        y = layer_norm(x, w[p + "ln1.scale"], w[p + "ln1.bias"], eps)
        qkv = _mm(y, w[p + "qkv.kernel"], mode)
        q, k, v = (t.reshape(b, l, h, hd).transpose(1, 2)
                   for t in qkv.split(d, dim=-1))
        s = _mm(q, k.transpose(-1, -2), mode) / math.sqrt(hd)
        s = s.masked_fill(~causal, float("-inf"))
        a = _mm(torch.softmax(s, dim=-1), v, mode)
        x = x + _mm(a.transpose(1, 2).reshape(b, l, d), w[p + "proj.kernel"],
                    mode)
        y = layer_norm(x, w[p + "ln2.scale"], w[p + "ln2.bias"], eps)
        y = F.gelu(_mm(y, w[p + "mlp_in.kernel"], mode) + w[p + "mlp_in.bias"],
                   approximate="tanh")
        x = x + _mm(y, w[p + "mlp_out.kernel"], mode) + w[p + "mlp_out.bias"]
    x = layer_norm(x, w["ln_f.scale"], w["ln_f.bias"], eps)
    return _mm(x, w["lm_head.kernel"], mode)


# tokens a block of rows holds in one forward and backward: the float32
# activations of a whole batch of the cells' size outgrow the card
BLOCK_TOKENS = 4096


def loss_and_grads(params, names, inputs, targets, model, mode: str,
                   block_rows: int):
    """Mean next-token cross entropy over every position of the batch and
    its gradients, summed over blocks of ``block_rows`` rows."""
    grads = [torch.zeros_like(p) for p in params]
    cur = dict(zip(names, params))
    loss = 0.0
    for r in range(0, inputs.shape[0], block_rows):
        logits = forward(cur, inputs[r:r + block_rows], model, mode)
        part = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets[r:r + block_rows].reshape(-1),
                               reduction="sum") / targets.numel()
        for acc, g in zip(grads, torch.autograd.grad(part, params)):
            acc.add_(g)
        loss += part.item()
        del logits, part
    return loss, grads


class AdamW:
    """AdamW (decoupled decay on every leaf, bias-corrected moments) after
    a clip of the gradients' global norm: the recipe the configuration
    states, in float32."""

    def __init__(self, params: List[torch.Tensor], lr: float, b1: float,
                 b2: float, eps: float, weight_decay: float, clip: float):
        self.params = params
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.clip = weight_decay, clip
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        cs = (self.clip / norm).clamp(max=1.0) if self.clip > 0 else 1.0
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            g = g * cs
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            p.sub_(self.lr * ((m / c1) / (torch.sqrt(v / c2) + self.eps)
                              + self.wd * p))


def train_steps(w: Dict[str, torch.Tensor], batches: List[Tuple], model: dict,
                recipe: dict, mode: str = "fp32") -> dict:
    """Train float32 copies of ``w`` on ``batches`` ((inputs, targets)
    pairs): each step's loss, the first gradient's norm a leaf as the
    optimizer takes it (after the clip), and each leaf's change norm after
    the last step. Each batch runs in blocks of ``BLOCK_TOKENS`` tokens."""
    names = list(w)
    params = [w[n].detach().float().clone().requires_grad_(True)
              for n in names]
    start = [p.detach().clone() for p in params]
    opt = AdamW(params, recipe["lr"], recipe["b1"], recipe["b2"],
                recipe["eps"], recipe["weight_decay"], recipe["grad_clip"])
    losses, first = [], None
    for inputs, targets in batches:
        rows = max(1, BLOCK_TOKENS // inputs.shape[1])
        loss, grads = loss_and_grads(params, names, inputs, targets, model,
                                     mode, rows)
        losses.append(loss)
        opt.step(grads)
        if first is None:
            first = {n: float(m.norm()) / (1 - opt.b1)
                     for n, m in zip(names, opt.m)}
        del grads
    change = {n: float((p.detach() - s).norm())
              for n, p, s in zip(names, params, start)}
    return {"losses": losses, "grad_norms": first, "change_norms": change}
