"""Plain reference of GAT's inductive training (arXiv:1710.10903 §2.1,
§3.3; the PPI model): Adam steps over batches of whole graphs and
evaluations between them, in float32 with plain torch operations and
autograd, one dense masked softmax a graph and head as the oracle, and no
kernel, union, capture or batching of the program's. It imports nothing
of the program.

For each graph of a batch (n nodes, the adjacency with every self-loop),
layer by layer (K heads of D, slope 0.2):

- h = x W (W (F, K, D)); e_dst = h a_dst + b_dst, e_src = h a_src + b_src;
- z_ij = leaky_relu(e_dst_i + e_src_j) over j ∈ N(i) ∪ {i}, the softmax
  over them, out_i = Σ_j α_ij h_j + b;
- on the hidden layers after the first, the residual: x R where the input
  width differs from D, x itself where it matches (each head);
- hidden layers: elu, the K heads concatenated; the output layer: its
  heads averaged, no activation (the logits);

then each graph's masked mean sigmoid cross-entropy (the mean over the
labels, then over the graph's nodes), summed over the batch's graphs and
divided by the batch size B (a short last batch's missing graphs count as
empty graphs, as the program pads them), plus l2 · ½ Σ ‖θ‖², and Adam
(β = 0.9, 0.999, ε = 1e-8). An evaluation is the mean of its batches'
losses, without the L2 term.

Departures from the paper, as the program has them:

- the attention vector a is kept as two, a_dst and a_src, each with a
  bias (``GATConv``'s f_1 and f_2, the reference TF code's two 1x1
  convolutions), and the output bias b is added before the activation;
- the residual (the paper's "skip connection across the intermediate
  attentive layer") is a projection R only where the widths differ;
- no dropout: the configuration has none, and a setting with dropout is
  refused (NotImplementedError).

``products``: ``"f32"`` (float32, TF32 off) or ``"tf32"`` (each operand
of every product rounded to TF32 first), and ``fault`` (``"half_batch"``:
each graph's loss the mean over the first half of its nodes;
``"altered"``: one node's logit of the batch's first graph raised by 1),
as ``reference/han.py`` has them.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.han import BETAS, COMPARED_STEPS, EPS, Record, matmul_fn

SLOPE = 0.2


@dataclasses.dataclass
class Graph:
    """One graph: ``x`` (n, F) features, ``labels`` (n, C) multi-hot, ``adj``
    bool (n, n) with every self-loop (node i attends to node j)."""

    x: torch.Tensor
    labels: torch.Tensor
    adj: torch.Tensor


@dataclasses.dataclass
class Batch:
    """A step's graphs and the batch size B that divides their losses' sum."""

    graphs: list
    size: int


def _lrelu(x):
    return torch.where(x >= 0, x, SLOPE * x)


def _layer(params: dict, pre: str, h: torch.Tensor, adj: torch.Tensor, mm, *,
           residual: bool) -> torch.Tensor:
    """One attention layer: (n, K, D) before the activation."""
    w = params[pre + "kernel"]                                        # (F, K, D)
    f_in, k, d = w.shape
    n = h.shape[0]
    fts = mm(h, w.reshape(f_in, k * d)).view(n, k, d)
    fk = fts.permute(1, 0, 2)                                         # (K, n, D)
    ld = mm(fk, params[pre + "attn_dst_kernel"].unsqueeze(-1)).squeeze(-1).T \
        + params[pre + "attn_dst_bias"]
    ls = mm(fk, params[pre + "attn_src_kernel"].unsqueeze(-1)).squeeze(-1).T \
        + params[pre + "attn_src_bias"]
    outs = []
    for j in range(k):
        z = torch.where(adj, _lrelu(ld[:, j, None] + ls[None, :, j]), -torch.inf)
        e = torch.where(adj, torch.exp(z - z.amax(dim=1, keepdim=True).detach()), 0.0)
        outs.append(mm(e / e.sum(dim=1, keepdim=True), fk[j]))
    out = torch.stack(outs, dim=1) + params[pre + "bias"]
    if residual:
        if pre + "res_kernel" in params:
            out = out + mm(h, params[pre + "res_kernel"].reshape(f_in, k * d)).view(n, k, d)
        else:
            out = out + h.unsqueeze(1)
    return out


def logits(params: dict, g: Graph, mm, *, n_layers: int, residual: bool) -> torch.Tensor:
    """(n, C) logits of one graph."""
    h = g.x
    for i in range(n_layers - 1):
        out = _layer(params, f"layers.{i}.", h, g.adj, mm, residual=residual and i > 0)
        h = torch.nn.functional.elu(out).reshape(h.shape[0], -1)
    return _layer(params, f"layers.{n_layers - 1}.", h, g.adj, mm, residual=False).mean(dim=1)


def forward(params: dict, batch: Batch, mm, *, n_layers: int, residual: bool,
            fault: str | None = None) -> torch.Tensor:
    """The batch loss of one step (without the L2 term)."""
    total = 0.0
    for gi, g in enumerate(batch.graphs):
        lg = logits(params, g, mm, n_layers=n_layers, residual=residual)
        if fault == "altered" and gi == 0:
            bump = torch.zeros_like(lg)
            bump[0, 0] = 1.0
            lg = lg + bump
        y = g.labels
        loss = lg.clamp_min(0.0) - lg * y + torch.log1p(torch.exp(-lg.abs()))
        per_node = loss.mean(dim=1)
        if fault == "half_batch":
            per_node = per_node[:(per_node.shape[0] + 1) // 2]
        total = total + per_node.mean()
    return total / batch.size


def follow(settings: dict, params0: dict, batches: list, *, evals: dict, gen_seed: int,
           device, products: str = "f32", fault: str | None = None) -> Record:
    """The program settings' steps and evaluations: ``batches`` (Adam steps
    from ``params0``, the program's parameter names), and after step t the
    evaluation ``evals[t]`` (a list of batches) where there is one.
    ``gen_seed`` is not read: nothing is drawn."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m, t = settings["model"], settings["train"]
    if m["attn_drop"] > 0.0 or m["ffd_drop"] > 0.0:
        raise NotImplementedError("the GAT reference has no dropout")
    mm = matmul_fn(products)
    kw = dict(n_layers=len(m["n_heads"]), residual=bool(m["residual"]))
    lr, l2 = t["lr"], t["l2_coef"]
    params = {k: v.detach().clone().to(device).requires_grad_(True) for k, v in params0.items()}
    mom = {k: torch.zeros_like(v) for k, v in params.items()}
    sec = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grads, after, eval_losses = [], {}, {}, []
    for step, batch in enumerate(batches, start=1):
        for v in params.values():
            v.grad = None
        loss = forward(params, batch, mm, fault=fault, **kw)
        loss = loss + l2 * 0.5 * sum(v.square().sum() for v in params.values())
        loss.backward()
        if step <= COMPARED_STEPS:
            losses.append(float(loss.detach()))
        with torch.no_grad():
            if step == 1:
                grads = {k: v.grad.detach().clone() for k, v in params.items()}
            for k, v in params.items():
                g = v.grad
                mom[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                sec[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                bc1, bc2 = 1 - BETAS[0] ** step, 1 - BETAS[1] ** step
                v.sub_(lr / bc1 * mom[k] / (sec[k].sqrt() / bc2 ** 0.5 + EPS))
            if step == COMPARED_STEPS:
                after = {k: v.detach().clone() for k, v in params.items()}
            if step in evals:
                eval_losses.append(sum(float(forward(params, eb, mm, fault=fault, **kw))
                                       for eb in evals[step]) / len(evals[step]))
    return Record(losses, grads, after, eval_losses)
