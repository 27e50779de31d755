"""Plain PyTorch weakly supervised training step (COARSE3D's recipe).

Frozen copies, written out plainly, of what one step of the reference's
trainer does (``tasks/weak_segmentation/trainer.py``): focal loss and
Lovász-Softmax on the weak pixels, entropy-driven pseudo-label expansion,
prototype-anchor InfoNCE against the class memory, AdamW with the
warmup-cosine schedule, then the memory's Sinkhorn / EMA update. The noise
(selection and Sinkhorn Gumbel draws, anchor uniforms, dropout masks)
comes from a generator in the order and shapes the program draws it, so
both sides see the same numbers. Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

TINY = float(np.finfo(np.float32).tiny)


def focal_alpha(counts, ignore: int = 0) -> np.ndarray:
    c = np.asarray(counts, np.float64)
    weight = 1.0 / (c / c.sum() + 1e-3)
    weight[ignore] = 0.0
    alpha = np.log(1 + weight)
    alpha = alpha / alpha.max()
    alpha[ignore] = 0.0
    return alpha.astype(np.float32)


def lr_at(step: int, lr: float, warmup: int, total: int) -> float:
    """Linear warmup from 0, then cosine to 0; update ``step`` (0-based)."""
    warmup = max(warmup, 1)
    if step < warmup:
        return lr * step / warmup
    decay = max(total - warmup, 1)
    return lr * 0.5 * (1 + math.cos(math.pi * min(step - warmup, decay)
                                    / decay))


def gumbel(shape, g: torch.Generator) -> torch.Tensor:
    u = torch.rand(shape, generator=g, device=g.device)
    return -torch.log(-torch.log(torch.clamp_min(u, TINY)))


def draw_noise(g, b, h, w, c, anchors, m, k):
    return {"select": gumbel((b * h * w,), g),
            "anchor": torch.rand((b, c, anchors), generator=g, device=g.device),
            "proto": gumbel((c, m, k), g)}


def focal(probs, target, alpha, mask, gamma=2.0):
    c = probs.shape[-1]
    p = probs.reshape(-1, c)
    t = target.reshape(-1).long()
    pt = p.gather(1, t[:, None])[:, 0]
    loss = -((1 - pt) ** gamma) * torch.log(torch.clamp_min(pt, 1e-6)) * alpha[t]
    m = mask.reshape(-1).float()
    return (loss * m).sum() / torch.clamp_min(m.sum(), 1.0)


def lovasz(probs, labels, ignore=0):
    """Lovász-Softmax over the non-ignored pixels, mean over the classes
    present among them."""
    c = probs.shape[-1]
    p = probs.reshape(-1, c)
    lab = labels.reshape(-1).long()
    keep = lab != ignore
    p, lab = p[keep], lab[keep]
    terms = []
    for cls in range(c):
        fg = (lab == cls).float()
        if fg.sum() == 0:
            continue
        err = (fg - p[:, cls]).abs()
        err_s, order = torch.sort(err, descending=True, stable=True)
        fg_s = fg[order]
        gts = fg_s.sum()
        inter = gts - fg_s.cumsum(0)
        union = gts + (1 - fg_s).cumsum(0)
        jac = 1 - inter / union
        grad = torch.cat([jac[:1], jac[1:] - jac[:-1]])
        terms.append((err_s * grad).sum())
    if not terms:
        return probs.sum() * 0
    return torch.stack(terms).mean()


def _entropy(p):
    return -(p * torch.log(p + 1e-10)).sum(-1)


def select_pseudo(probs, wss, evalm, label, ratio, noise, ignore=0):
    """For each image and each class among its weak labels: of the pixels
    predicted as that class, the floor(ratio * count) with the highest
    -entropy + Gumbel; weak labels always win."""
    b, h, w, c = probs.shape
    p = probs.reshape(b, h * w, c)
    score = -_entropy(p) + noise.reshape(b, h * w)
    pred = torch.where(evalm.reshape(b, -1), p.argmax(-1), ignore)
    out = torch.full((b, h * w), ignore, dtype=torch.int64, device=p.device)
    lab = label.reshape(b, -1).long()
    wm = wss.reshape(b, -1)
    for i in range(b):
        present = torch.unique(lab[i][wm[i]]).tolist()
        for cls in present:
            if cls == ignore:
                continue
            cand = (pred[i] == cls).nonzero()[:, 0]
            k = int(math.floor(len(cand) * ratio))
            if k < 1:
                continue
            top = torch.topk(score[i, cand], k).indices
            out[i, cand[top]] = cls
    out = torch.where(wm, lab, out)
    return out.reshape(b, h, w), (out != ignore).reshape(b, h, w)


def l2n(x):
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1,
                                                        keepdim=True), 1e-12)


def contrast(emb, probs, labels, keep, protos, uniforms, temperature,
             base_temperature, ignore=0):
    """Anchors drawn with replacement per (image, present class) with
    weight exp(-entropy^2), by inverting the CDF at the given uniforms;
    InfoNCE against every sub-prototype of every non-ignore class."""
    b, h, w, d = emb.shape
    c, k, _ = protos.shape
    n = h * w
    a = uniforms.shape[-1]
    lab = torch.where(keep, labels, ignore).reshape(b, n)
    feat = emb.reshape(b, n, d)
    ent = _entropy(probs.reshape(b, n, c))
    weight = torch.exp(-(ent * ent))
    cls = torch.arange(c, device=emb.device)
    onehot = lab[:, None, :] == cls[None, :, None]
    valid = onehot.any(-1) & (cls != ignore)[None]
    cdf = torch.cumsum(torch.where(onehot, weight[:, None, :], 0.0), -1)
    draws = torch.searchsorted(cdf, (uniforms * cdf[..., -1:]).contiguous(),
                               right=True).clamp(0, n - 1)
    anchors = feat[torch.arange(b, device=emb.device)[:, None, None], draws]
    q = l2n(protos).reshape(c * k, d)
    qcls = cls.repeat_interleave(k)
    qok = qcls != ignore
    af = l2n(anchors.reshape(-1, d))
    acls = cls[None, :, None].expand(b, c, a).reshape(-1)
    aok = valid[..., None].expand(b, c, a).reshape(-1).float()
    sims = af @ q.T / temperature
    sims = torch.where(qok[None], sims, float("-inf"))
    sims = sims - sims.max(1, keepdim=True).values.detach()
    pos = (acls[:, None] == qcls[None]) & qok
    ex = torch.where(qok[None], torch.exp(sims), 0.0)
    neg = (ex * (~pos)).sum(1, keepdim=True)
    logp = sims - torch.log(ex + neg + 1e-6)
    mean_pos = torch.where(pos, logp, 0.0).sum(1) / pos.sum(1).clamp_min(1)
    per = -(temperature / base_temperature) * mean_pos
    return (per * aok).sum() / aok.sum().clamp_min(1.0)


def _ln(x, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + eps)


def update_memory(protos, emb, label, wss, noise, m_budget, momentum,
                  ignore=0, iters=3, eps=0.05):
    """Per class: its first ``m_budget`` weak pixels (pixel order), LayerNorm
    + l2; keep those whose nearest class (after a LayerNorm over the class
    maxima) is their own; Sinkhorn over the class's sub-prototypes, hard
    assignment argmax(Q + Gumbel); the mean of each sub-prototype's rows,
    l2; EMA into occupied rows; l2."""
    c, k, d = protos.shape
    b, h, w, _ = emb.shape
    flat = emb.reshape(-1, d)
    lab = label.reshape(-1)
    ok = wss.reshape(-1) & (lab != ignore)
    pn = l2n(protos)
    new = pn.clone()
    for cls in range(c):
        if cls == ignore:
            continue
        idx = ((lab == cls) & ok).nonzero()[:m_budget, 0]
        if len(idx) == 0:
            continue
        f = l2n(_ln(flat[idx]))
        near = torch.einsum("nd,jkd->njk", f, pn).amax(-1)
        agree = torch.argmax(_ln(near), -1) == cls
        sim = f @ pn[cls].T
        q = torch.exp(sim / eps - (sim / eps).max())
        q = q / q.sum()
        nv = len(idx)
        for _ in range(iters):
            q = q / q.sum(0, keepdim=True) / k
            q = q / q.sum(1, keepdim=True) / nv
        q = q * nv
        hard = torch.argmax(q + noise[cls, :nv], -1)
        mq = F.one_hot(hard, k).float() * agree[:, None].float()
        mean = l2n(mq.T @ f)
        occ = mq.sum(0) > 0
        new[cls] = torch.where(occ[:, None],
                               momentum * pn[cls] + (1 - momentum) * mean,
                               pn[cls])
    return l2n(new)


class AdamW:
    """torch.optim.AdamW's update, written out (decoupled weight decay)."""

    def __init__(self, params, betas=(0.9, 0.999), eps=1e-8, wd=0.01):
        self.params = list(params)
        self.b1, self.b2 = betas
        self.eps, self.wd, self.t = eps, wd, 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, lr: float):
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = 1 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            p.mul_(1 - lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = v.sqrt() / math.sqrt(bc2) + self.eps
            p.addcdiv_(m, denom, value=-lr / bc1)


def step(model, opt, protos, batch, gen, hp: dict, step_index: int,
         keep_batch: int | None = None):
    """One training step on ``batch`` (tensors on the model's device).
    Returns (losses: the total and its terms, new memory, gradients by
    parameter name).
    ``keep_batch`` keeps only the first images (a planted fault for the
    control)."""
    if keep_batch is not None:
        batch = {k: v[:keep_batch] for k, v in batch.items()}
    tl = batch["train_label"].long()
    el = batch["eval_label"]
    wss, evalm = tl > 0, el > 0
    b, h, w = tl.shape
    c, k, _ = protos.shape
    full_b = b if keep_batch is None else hp["batch"]
    noise = draw_noise(gen, full_b, h, w, c, hp["num_anchor"], hp["m_budget"],
                       k)
    if keep_batch is not None:
        noise["select"] = noise["select"][:b * h * w]
        noise["anchor"] = noise["anchor"][:b]
    mean = torch.tensor(hp["img_mean"], device=tl.device)
    std = torch.tensor(hp["img_stds"], device=tl.device)
    x = (batch["features"].float() - mean) / std * evalm[..., None].float()
    model.train()
    for p in model.parameters():
        p.grad = None
    out = model(x.permute(0, 3, 1, 2).contiguous(), return_feat=True,
                generator=gen)
    probs = torch.softmax(out["logits"], 1).permute(0, 2, 3, 1)
    emb = out["embedding"].permute(0, 2, 3, 1)
    alpha = torch.from_numpy(hp["alpha"]).to(tl.device)
    parts = {"focal": focal(probs, tl, alpha, wss), "lovasz": lovasz(probs, tl)}
    pl, pm = select_pseudo(probs.detach(), wss, evalm, tl, hp["ratio"],
                           noise["select"])
    parts["contrast"] = contrast(emb, probs.detach(), pl, pm, protos,
                                 noise["anchor"], hp["temperature"],
                                 hp["base_temperature"])
    total = parts["focal"] + parts["lovasz"] + hp["w_contrast"] * (
        parts["contrast"])
    total.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    opt.step(lr_at(step_index, hp["lr"], hp["warmup_steps"], hp["total_steps"]))
    new = update_memory(protos, emb.detach(), tl, wss, noise["proto"],
                        hp["m_budget"], hp["momentum"])
    losses = {k: float(v.detach()) for k, v in parts.items()}
    losses["total"] = float(total.detach())
    return losses, new, grads
