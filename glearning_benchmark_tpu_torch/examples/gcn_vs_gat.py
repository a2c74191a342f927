"""GCN against GAT on node classification (the root
``examples/gcn_vs_gat.py`` on PyTorch): a 2-layer GCN and a 2-layer GAT
trained full-batch on a seeded citation-network stand-in.

    python -m glearning_benchmark_tpu_torch.examples.gcn_vs_gat \
        [--epochs 300] [--device cpu] [--figures DIR] [--out runs_torch/gcn_vs_gat.json]

No dataset is downloaded: the Cora stand-in (``make_citation_sbm``, a copy
of the reference's, the same bytes for the same seed) is a 4-community
stochastic block model with bag-of-words-style features and a Cora-style
split (20 labelled nodes a class for training). Both models are dense, as
the reference's: GCN is products with the normalised adjacency
D^-1/2 (A + I) D^-1/2, GAT dense masked multi-head attention over the
self-loop-augmented neighbourhood, one [N, N] score matrix a head; the
products are ``torch.matmul``/``einsum``. Dropout is the port's
``hash_dropout`` (the hash-dropout kernel on the card), with seeds drawn
from a ``torch.Generator``, where the reference draws flax's threefry masks.
AdamW (lr 0.01, weight decay 5e-4), the cross-entropy over the training
nodes, and the parameters of the best validation epoch, as the reference.
Prints the accuracies with the card and writes them to ``--out``.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import hash_dropout
from ..tools import RESULTS_DIR, emit, save
from ..utils.card import device_info
from ..utils.device import resolve_device


# ---------------------------------------------------------------------------
# the citation-network stand-in (the reference's, copied)
# ---------------------------------------------------------------------------

def make_citation_sbm(num_nodes=400, num_classes=4, feat_dim=64, seed=0):
    """4-block SBM + noisy prototype features, Cora-style node split."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=num_nodes)
    p_in, p_out = 0.035, 0.008
    iu, iv = np.triu_indices(num_nodes, k=1)
    prob = np.where(labels[iu] == labels[iv], p_in, p_out)
    keep = rng.random(iu.shape[0]) < prob
    edges = np.stack([iu[keep], iv[keep]], axis=1)

    # bag-of-words analogue: each class has a sparse binary prototype; a
    # node samples its prototype's words unreliably, over heavy background
    # noise, so the graph structure carries most of the signal
    protos = rng.random((num_classes, feat_dim)) < 0.2
    x = np.zeros((num_nodes, feat_dim), np.float32)
    for i in range(num_nodes):
        on = protos[labels[i]] & (rng.random(feat_dim) < 0.35)
        noise = rng.random(feat_dim) < 0.12
        x[i] = (on | noise).astype(np.float32)

    # Cora-style split: 20 train nodes per class, 100 val, rest test
    train_mask = np.zeros(num_nodes, bool)
    for c in range(num_classes):
        idx = np.flatnonzero(labels == c)
        train_mask[rng.choice(idx, size=min(20, len(idx)), replace=False)] = True
    rest = np.flatnonzero(~train_mask)
    rng.shuffle(rest)
    val_mask = np.zeros(num_nodes, bool)
    val_mask[rest[:100]] = True
    test_mask = np.zeros(num_nodes, bool)
    test_mask[rest[100:]] = True
    return x, edges, labels, train_mask, val_mask, test_mask


def graph_operators(edges: np.ndarray, n: int):
    """(the normalised adjacency D^-1/2 (A + I) D^-1/2, the mask of A + I)."""
    a = np.zeros((n, n), np.float32)
    a[edges[:, 0], edges[:, 1]] = 1.0
    a[edges[:, 1], edges[:, 0]] = 1.0
    a_self = a + np.eye(n, dtype=np.float32)
    d_inv_sqrt = 1.0 / np.sqrt(a_self.sum(1))
    return a_self * d_inv_sqrt[:, None] * d_inv_sqrt[None, :], a_self > 0


# ---------------------------------------------------------------------------
# the models: parameters in the flax layout ([in, out] kernels)
# ---------------------------------------------------------------------------

def _lecun_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at 2 sigma, variance
    1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
    return w


def _glorot_uniform(shape, gen: torch.Generator) -> torch.Tensor:
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    return (torch.rand(shape, generator=gen) * 2 - 1) * limit


class Dropout:
    """Inverted dropout by ``hash_dropout``, a seed a call from the
    generator; off outside training."""

    def __init__(self, rate: float, gen: torch.Generator):
        self.rate, self.gen = rate, gen

    def __call__(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            return x
        seed = int(torch.randint(0, 2**31 - 1, (), generator=self.gen))
        return hash_dropout(seed, x, self.rate)


class GCN(nn.Module):
    """h' = ReLU(Â h W), two layers, dropout 0.5 before each."""

    def __init__(self, feat_dim: int, num_classes: int, hidden: int, gen: torch.Generator):
        super().__init__()
        self.dense_0 = nn.Parameter(_lecun_normal((feat_dim, hidden), feat_dim, gen))
        self.dense_1 = nn.Parameter(_lecun_normal((hidden, num_classes), hidden, gen))
        self.drop = Dropout(0.5, gen)

    def forward(self, x, a_norm, train: bool):
        x = self.drop(x, train)
        x = F.relu(a_norm @ (x @ self.dense_0))
        x = self.drop(x, train)
        return a_norm @ (x @ self.dense_1)


class GATLayer(nn.Module):
    """Dense masked attention: e_ij = LeakyReLU(a_l.Wh_i + a_r.Wh_j),
    softmax over the (self-loop-augmented) neighbourhood, a [N, N] score
    matrix a head."""

    def __init__(self, in_dim: int, out_dim: int, n_heads: int, concat: bool,
                 gen: torch.Generator, drop: Dropout):
        super().__init__()
        self.kernel = nn.Parameter(_lecun_normal((in_dim, n_heads, out_dim), in_dim, gen))
        self.a_l = nn.Parameter(_glorot_uniform((n_heads, out_dim), gen))
        self.a_r = nn.Parameter(_glorot_uniform((n_heads, out_dim), gen))
        self.concat, self.drop = concat, drop

    def forward(self, x, adj_mask, train: bool):
        h = torch.einsum("ni,ihd->nhd", x, self.kernel)
        left = torch.einsum("nhd,hd->nh", h, self.a_l)
        right = torch.einsum("nhd,hd->nh", h, self.a_r)
        scores = F.leaky_relu(left.T[:, :, None] + right.T[:, None, :], 0.2)   # [H, N, N]
        scores = torch.where(adj_mask[None], scores, -1e9)
        attn = self.drop(torch.softmax(scores, dim=-1), train)
        out = torch.einsum("hij,jhd->ihd", attn, h)                          # [N, H, D]
        return out.reshape(out.shape[0], -1) if self.concat else out.mean(dim=1)


class GAT(nn.Module):
    """The reference's GAT: an 8-head concat layer, ELU, a one-head output
    layer; dropout 0.6 on the inputs and the attention."""

    def __init__(self, feat_dim: int, num_classes: int, heads: int, gen: torch.Generator):
        super().__init__()
        self.drop = Dropout(0.6, gen)
        self.layer_0 = GATLayer(feat_dim, 8, heads, True, gen, self.drop)
        self.layer_1 = GATLayer(8 * heads, num_classes, 1, False, gen, self.drop)

    def forward(self, x, adj_mask, train: bool):
        x = self.drop(x, train)
        x = F.elu(self.layer_0(x, adj_mask, train))
        x = self.drop(x, train)
        return self.layer_1(x, adj_mask, train)


def build_models(feat_dim: int, num_classes: int, hidden: int = 16, heads: int = 8,
                 seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    return GCN(feat_dim, num_classes, hidden, gen), GAT(feat_dim, num_classes, heads, gen)


# ---------------------------------------------------------------------------
# training: full batch
# ---------------------------------------------------------------------------

def train_model(name: str, model: nn.Module, graph_arg, x, y, masks, epochs: int,
                lr: float = 0.01) -> Dict:
    train_mask, val_mask, test_mask = masks
    opt = torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=5e-4)

    def accuracies():
        with torch.no_grad():
            hit = model(x, graph_arg, train=False).argmax(-1) == y
        return [float(hit[m].float().mean()) for m in (train_mask, val_mask, test_mask)]

    losses, val_accs = [], []
    best_val, best = -1.0, None
    t0 = time.time()
    for epoch in range(epochs):
        model.train()
        ll = F.cross_entropy(model(x, graph_arg, train=True), y, reduction="none")
        loss = torch.where(train_mask, ll, 0.0).sum() / train_mask.sum()
        opt.zero_grad()
        loss.backward()
        opt.step()
        va = accuracies()[1]
        losses.append(float(loss))
        val_accs.append(va)
        if va > best_val:
            best_val, best = va, {k: v.detach().clone() for k, v in model.state_dict().items()}
        if (epoch + 1) % max(1, epochs // 5) == 0:
            print(f"  [{name}] epoch {epoch + 1:4d} loss {losses[-1]:.4f} val acc {va:.4f}")
    model.load_state_dict(best)
    tr, va, te = accuracies()
    print(f"  [{name}] done in {time.time() - t0:.1f}s — best-val params: "
          f"train {tr:.4f} val {va:.4f} test {te:.4f}")
    return {"losses": losses, "val_accs": val_accs, "train": tr, "val": va, "test": te}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--figures", default=None)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "gcn_vs_gat.json"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = device_info(device)

    x, edges, y, train_mask, val_mask, test_mask = make_citation_sbm()
    n = x.shape[0]
    print(f"Citation-network stand-in: nodes {n} | edges {len(edges)} | features "
          f"{x.shape[1]} | classes {y.max() + 1}; split: train {train_mask.sum()} / val "
          f"{val_mask.sum()} / test {test_mask.sum()}")
    a_norm, adj_mask = graph_operators(edges, n)
    on = {"device": device}
    xt, yt = torch.from_numpy(x).to(**on), torch.from_numpy(y).to(**on)
    masks = tuple(torch.from_numpy(m).to(**on) for m in (train_mask, val_mask, test_mask))
    gcn, gat = (m.to(device) for m in build_models(x.shape[1], int(y.max()) + 1))

    print("Training GCN (2-layer, normalised-adjacency products)...")
    r_gcn = train_model("gcn", gcn, torch.from_numpy(a_norm).to(**on), xt, yt, masks,
                        args.epochs)
    print("Training GAT (8-head dense masked attention)...")
    r_gat = train_model("gat", gat, torch.from_numpy(adj_mask).to(**on), xt, yt, masks,
                        args.epochs)
    rows = {nm: {k: r[k] for k in ("train", "val", "test")}
            for nm, r in (("GCN", r_gcn), ("GAT", r_gat))}
    print(f"{'model':6s} {'train':>8s} {'val':>8s} {'test':>8s}")
    for nm, r in rows.items():
        print(f"{nm:6s} {r['train']:8.4f} {r['val']:8.4f} {r['test']:8.4f}")
    save(args.out, {"card": card, "epochs": args.epochs, "accuracies": rows,
                    "curves": {nm: {"losses": r["losses"], "val_accs": r["val_accs"]}
                               for nm, r in (("GCN", r_gcn), ("GAT", r_gat))}})

    if args.figures:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        os.makedirs(args.figures, exist_ok=True)
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(14, 5))
        for nm, r, c in (("GCN", r_gcn, "tab:blue"), ("GAT", r_gat, "tab:red")):
            ax1.plot(r["losses"], color=c, label=nm)
            ax2.plot(r["val_accs"], color=c, label=nm)
        ax1.set_xlabel("Epoch")
        ax1.set_ylabel("Training loss")
        ax2.set_xlabel("Epoch")
        ax2.set_ylabel("Validation accuracy")
        for ax in (ax1, ax2):
            ax.grid(True, alpha=0.3)
            ax.legend()
        path = os.path.join(args.figures, "gcn_vs_gat.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        print(f"wrote {path}")
    return emit({"summary": "gcn_vs_gat", "epochs": args.epochs, "accuracies": rows,
                 "device": device.type, "out": args.out}, card)


if __name__ == "__main__":
    main()
