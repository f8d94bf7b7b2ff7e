"""Plain reference of HAN training (han.pdf §4; the model of
arXiv:1903.07293): Adam steps of the node-level attention towers, semantic
attention and the classifier, and evaluations between them (the forward
without dropout), in float32 with plain torch operations and autograd, and
no kernel, capture or batching of the program's. It imports nothing of the
program.

One step, per meta-path tower p (K heads of D, slope 0.2):

- input dropout, one mask a head: x_k = x · keep_k / (1 − p_in);
- h_k = x_k W_k; e_dst = h_k a_dst + b_dst, e_src = h_k a_src + b_src;
- feature dropout on h before it is aggregated;
- z_ij = leaky_relu(e_dst_i + e_src_j) over i's in-neighbours j, the
  softmax over them, then coefficient dropout, out_i = Σ_j c_ij h_j;
- elu(out + bias), the K heads concatenated;

then semantic attention (tanh(Z W + b) u, a softmax over the meta-paths
per node), logits = Z_sem W_c + b_c, the masked mean cross-entropy plus
l2 · ½ Σ ‖θ‖², and Adam (β = 0.9, 0.999, ε = 1e-8).

The random streams are worked out again from the run's seed: the dropout
masks are drawn from a ``torch.Generator`` seeded as the program seeds its
dropout generator, in the program's order (per tower: the input mask
(K, N, F), the feature mask (N, K, D), then the coefficient draw: a
full-graph step's one int32 seed for the counter hash of
:func:`hash_keep`, a sampled block's (N, F, K) uniform mask), so the same
seed gives the same masks on both sides.

``products`` selects how every matrix product is taken: ``"f32"``
(float32, TF32 off), or ``"tf32"``, each operand rounded to TF32 first,
the control in the nearest precision below float32. ``fault`` plants a
fault for the control runs: ``"half_batch"`` (the loss is the mean over
the first half of the batch's rows), ``"altered"`` (one batch row's logits
raised by 1 where they are produced).
"""

from __future__ import annotations

import dataclasses

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
SLOPE = 0.2
BETAS = (0.9, 0.999)
EPS = 1e-8


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _MatmulTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(tf32_round(a), tf32_round(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return (torch.matmul(g, tf32_round(b).transpose(-1, -2)),
                torch.matmul(tf32_round(a).transpose(-1, -2), g))


def matmul_fn(products: str):
    if products == "f32":
        return torch.matmul
    if products == "tf32":
        return _MatmulTF32.apply
    raise ValueError(f"products {products!r}")


# ---------------------------------------------------------------------------
# coefficient dropout of the full-graph step: a counter hash of (seed, row,
# column, head)
# ---------------------------------------------------------------------------

def _mul32(x, c: int):
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_keep(seed: torch.Tensor, n: int, head: int, p: float) -> torch.Tensor:
    """bool (n, n): the kept coefficients of ``head``: the murmur3
    finalizer over (seed, head), then the row, then the column times the
    golden ratio, kept where the 32 bits fall under (1 − p) · 2³²."""
    dev = seed.device
    s = seed.reshape(()).to(torch.int64) & M32
    head_key = _fmix32(s ^ _fmix32((head + GOLDEN) & M32))
    idx = torch.arange(n, device=dev, dtype=torch.int64)
    row_key = _fmix32(head_key ^ idx)
    bits = _fmix32(row_key[:, None] ^ _mul32(idx, GOLDEN)[None, :])
    return bits < min(int((1.0 - p) * 2 ** 32), M32)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Batch:
    """One step's inputs. Full graph: ``adj`` per meta-path a bool (N, N)
    with self-loops, ``x`` the (N, F) features shared by the towers. A
    sampled block: ``nbr`` per meta-path (N, F) local rows (pad N), ``x``
    per meta-path the block's (N, F) feature rows. ``mask`` (N,) float,
    the rows the loss averages; ``labels`` (N, C) one-hot."""

    x: list
    labels: torch.Tensor
    mask: torch.Tensor
    adj: list | None = None
    nbr: list | None = None


def _lrelu(x):
    return torch.where(x >= 0, x, SLOPE * x)


def _dense_attention(adj, ld, ls, v, keep_seed, p_coef, mm):
    """Full graph: out (N, K, D) over the (N, N) adjacency."""
    n, k = ld.shape
    outs = []
    for h in range(k):
        z = torch.where(adj, _lrelu(ld[:, h, None] + ls[None, :, h]), -torch.inf)
        e = torch.where(adj, torch.exp(z - z.amax(dim=1, keepdim=True).detach()), 0.0)
        c = e / e.sum(dim=1, keepdim=True)
        if p_coef > 0.0:
            c = torch.where(hash_keep(keep_seed, n, h, p_coef), c / (1.0 - p_coef), 0.0)
        outs.append(mm(c, v[:, h, :]))
    return torch.stack(outs, dim=1)


def _ell_attention(nbr, ld, ls, v, keep, p_coef, mm):
    """Sampled block: out (N, K, D) over the (N, F) neighbour slots."""
    n, k = ld.shape
    valid = nbr < n
    safe = torch.where(valid, nbr, 0)
    z = torch.where(valid[:, :, None], _lrelu(ld[:, None, :] + ls[safe]), -torch.inf)
    m = z.amax(dim=1, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.where(valid[:, :, None], torch.exp(z - m), 0.0)
    c = e / e.sum(dim=1, keepdim=True).clamp_min(1e-30)
    if keep is not None:
        c = torch.where(keep, c / (1.0 - p_coef), 0.0)
    vals = torch.where(valid[:, :, None, None], v[safe], 0.0)          # (N, F, K, D)
    # one (1, F) x (F, D) product a row and head
    out = mm(c.permute(0, 2, 1).unsqueeze(2), vals.permute(0, 2, 1, 3))
    return out.squeeze(2)


def forward(params: dict, batch: Batch, gen: torch.Generator | None, *, heads: int,
            p_in: float, p_coef: float, mm, fault: str | None = None) -> torch.Tensor:
    """The masked mean cross-entropy of one step (without the L2 term),
    drawing the step's dropout masks from ``gen``."""
    n_paths = len(batch.adj if batch.adj is not None else batch.nbr)
    embeds = []
    for p in range(n_paths):
        pre = f"towers.{p}.layers.0."
        w = params[pre + "kernel"]                                    # (F, K, D)
        f_in, k, d = w.shape
        x = batch.x[0] if batch.adj is not None else batch.x[p]
        n = x.shape[0]
        keep_in = 1.0 - p_in
        if p_in > 0.0:
            mask = torch.rand((k, n, f_in), generator=gen, device=x.device) < keep_in
            xk = torch.where(mask, x.unsqueeze(0) / keep_in, 0.0)
        else:
            xk = x.unsqueeze(0).expand(k, n, f_in)
        fts = mm(xk, w.permute(1, 0, 2)).permute(1, 0, 2)              # (N, K, D)
        fk = fts.permute(1, 0, 2)                                      # (K, N, D)
        ld = mm(fk, params[pre + "attn_dst_kernel"].unsqueeze(-1)).squeeze(-1).T \
            + params[pre + "attn_dst_bias"]
        ls = mm(fk, params[pre + "attn_src_kernel"].unsqueeze(-1)).squeeze(-1).T \
            + params[pre + "attn_src_bias"]
        v = fts
        if p_in > 0.0:
            mask = torch.rand(fts.shape, generator=gen, device=x.device) < keep_in
            v = torch.where(mask, fts / keep_in, 0.0)
        if batch.adj is not None:
            seed = (torch.randint(0, 2 ** 31 - 1, (1,), generator=gen, device=x.device,
                                  dtype=torch.int32) if p_coef > 0.0 else None)
            agg = _dense_attention(batch.adj[p], ld, ls, v, seed, p_coef, mm)
        else:
            nbr = batch.nbr[p]
            keep = (torch.rand((n, nbr.shape[1], k), generator=gen, device=x.device)
                    < 1.0 - p_coef if p_coef > 0.0 else None)
            agg = _ell_attention(nbr, ld, ls, v, keep, p_coef, mm)
        out = torch.nn.functional.elu(agg + params[pre + "bias"])
        embeds.append(out.reshape(n, k * d))
    z = torch.stack(embeds, dim=1)                                     # (N, P, E)
    t = torch.tanh(mm(z, params["semantic.w_omega"]) + params["semantic.b_omega"])
    vu = mm(t, params["semantic.u_omega"].unsqueeze(-1)).squeeze(-1)  # (N, P)
    alphas = torch.softmax(vu, dim=-1)
    fused = (z * alphas[:, :, None]).sum(dim=1)
    heads_out = [mm(fused, params[f"classifiers.{i}.kernel"]) + params[f"classifiers.{i}.bias"]
                 for i in range(heads)]
    logits = sum(heads_out) / len(heads_out)
    mask = batch.mask
    rows = torch.nonzero(mask > 0).flatten()
    if fault == "altered":
        bump = torch.zeros_like(logits)
        bump[rows[0], 0] = 1.0
        logits = logits + bump
    if fault == "half_batch":
        mask = mask.clone()
        mask[rows[rows.shape[0] // 2:]] = 0.0
    loss_i = -(batch.labels * torch.log_softmax(logits, dim=-1)).sum(dim=-1)
    return (loss_i * mask).sum() / mask.sum()


COMPARED_STEPS = 3


@dataclasses.dataclass
class Record:
    """What a run leaves to compare: the first three steps' losses, the
    first step's gradient by leaf, the parameters after the third step,
    and the losses of the evaluations compared."""

    losses: list
    grads: dict
    params: dict
    evals: list


def follow(settings: dict, params0: dict, batches: list, *, evals: dict, gen_seed: int,
           device, products: str = "f32", fault: str | None = None) -> Record:
    """The program settings' steps and evaluations (:func:`train_steps`)."""
    m, t = settings["model"], settings["train"]
    return train_steps(params0, batches, evals=evals, gen_seed=gen_seed, device=device,
                       heads=m["n_heads"][-1], p_in=m["ffd_drop"], p_coef=m["attn_drop"],
                       lr=t["lr"], l2=t["l2_coef"], products=products, fault=fault)


def train_steps(params0: dict, batches: list, *, evals: dict, gen_seed: int, device,
                heads: int, p_in: float, p_coef: float, lr: float, l2: float,
                products: str = "f32", fault: str | None = None) -> Record:
    """Len(batches) Adam steps from ``params0`` (name → tensor, the
    program's parameter names), the dropout masks drawn from a generator
    on ``device`` seeded with ``gen_seed``; after step t, the evaluation
    ``evals[t]`` (a list of batches) if there is one: the masked mean
    cross-entropy over all its batches' rows, without dropout and without
    the L2 term."""
    mm = matmul_fn(products)
    params = {k: v.detach().clone().to(device).requires_grad_(True) for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    s = {k: torch.zeros_like(v) for k, v in params.items()}
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    losses, grads, after, eval_losses = [], {}, {}, []
    for t, batch in enumerate(batches, start=1):
        for v in params.values():
            v.grad = None
        loss = forward(params, batch, gen, heads=heads, p_in=p_in, p_coef=p_coef, mm=mm,
                       fault=fault)
        loss = loss + l2 * 0.5 * sum(v.square().sum() for v in params.values())
        loss.backward()
        if t <= COMPARED_STEPS:
            losses.append(float(loss))
        with torch.no_grad():
            if t == 1:
                grads = {k: v.grad.detach().clone() for k, v in params.items()}
            for k, v in params.items():
                g = v.grad
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                s[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                bc1, bc2 = 1 - BETAS[0] ** t, 1 - BETAS[1] ** t
                v.sub_(lr / bc1 * m[k] / (s[k].sqrt() / bc2 ** 0.5 + EPS))
            if t == COMPARED_STEPS:
                after = {k: v.detach().clone() for k, v in params.items()}
            if t in evals:
                sums = [(forward(params, eb, None, heads=heads, p_in=0.0, p_coef=0.0, mm=mm,
                                 fault=fault) * eb.mask.sum(), eb.mask.sum())
                        for eb in evals[t]]
                eval_losses.append(float(sum(x for x, _ in sums) / sum(n for _, n in sums)))
    return Record(losses, grads, after, eval_losses)
