"""Batched inference from a training checkpoint (the serving path).

Port of ``glearning_benchmark_tpu/serve.py`` for all four model families:
restore a checkpoint written by either package (with its ``batch_stats``
for the graph models), rebuild the model, encode raw inputs through the
same byte-exact tokenizers and graph batching training used (token rows
for ``ibtt``/``agtt``, dense padded graphs at the checkpoint's node bucket
``n_max`` for ``mpnn``/``ggps``), and run batched forwards in power-of-two
row buckets.

The model runs on ``device``: ``"cuda"`` unless the caller passes
``device="cpu"``. Without a GPU, the default raises; it never falls back
to the CPU. On the GPU every encoder layer's attention is one launch of
the flash-attention kernel; the graph models use no hand-written kernel.

Usage:
    from glearning_benchmark_tpu_torch.serve import Predictor
    p = Predictor.from_checkpoint("out/best_run")          # on cuda
    out = p.predict_graphs([Graph(...), ...])
    out["pred"]          # int class ids, or float values for zinc
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .convert import load_flax_params
from .data.graphs import Graph, batch_graphs
from .tokenization.ibtt import encode_texts, tokenize_zinc_molecule
from .tokenization.pack import pad_sequences
from .tokenization.vocab import build_fixed_zinc_vocab
from .train.checkpoint import load_checkpoint
from .train.datasets import QUERY_TASKS, SPLITS, DatasetBundle
from .train.trainer import build_model
from .utils.device import resolve_device


def _next_pow2(n: int, cap: int) -> int:
    b = 1
    while b < min(n, cap):
        b <<= 1
    # a non-power-of-two cap stays the hard bucket ceiling
    return min(b, cap)


class Predictor:
    """Checkpoint-backed batched inference."""

    def __init__(self, model_name: str, config: dict, params: Any,
                 batch_stats: Any, vocab: Optional[Dict[str, int]],
                 serve: Dict[str, Any], max_batch: int = 512,
                 device: Optional[str | torch.device] = None):
        self.device = resolve_device(device)
        self.model_name = model_name
        self.task = serve["task"]
        self.kind = serve["kind"]
        self.serve = serve
        self.vocab = vocab
        self.max_batch = max_batch
        self.bundle = DatasetBundle(
            task=self.task, kind=self.kind,
            splits={s: {"y": np.zeros(0)} for s in SPLITS},
            num_classes=serve["num_classes"], vocab=vocab,
            vocab_size=serve["vocab_size"], q_token_id=serve["q_token_id"],
            in_dim=serve["in_dim"], meta=dict(serve["meta"]))
        self.model = build_model(model_name, config, self.bundle)
        if batch_stats is None and next(self.model.buffers(), None) is not None:
            raise ValueError(f"{model_name} checkpoint without batch_stats: "
                             "its BatchNorm running statistics are missing")
        load_flax_params(self.model, params, batch_stats)
        self.model.to(self.device).eval()
        self._tok = None  # TrailTokenizer, built on first use (agtt)

    # -- construction -----------------------------------------------------

    @classmethod
    def from_checkpoint(cls, path: str, model_name: Optional[str] = None,
                        max_batch: int = 512,
                        device: Optional[str | torch.device] = None
                        ) -> "Predictor":
        ckpt = load_checkpoint(path)
        if ckpt is None:
            raise FileNotFoundError(f"no checkpoint at {path!r}")
        config = ckpt.get("config") or {}
        serve = ckpt.get("serve")
        if serve is None:
            # a checkpoint from before the serve block: rebuild the bundle
            # from the stored config (needs the corpus)
            from .train.checkpoint import serving_meta
            from .train.datasets import build_dataset
            if model_name is None:
                raise ValueError("old checkpoint without serve metadata: "
                                 "pass model_name=")
            seed = int(config.get("train", {}).get("seed", 0))
            bundle = build_dataset(model_name, config["dataset"], seed)
            serve = serving_meta(model_name, bundle)
            if ckpt.get("vocab") is None:
                ckpt["vocab"] = bundle.vocab
        return cls(model_name or serve["model_name"], config,
                   ckpt["params"], ckpt.get("batch_stats"), ckpt.get("vocab"),
                   serve, max_batch=max_batch, device=device)

    # -- forward ------------------------------------------------------------

    def _apply(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        t = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
        with torch.inference_mode():
            if self.kind == "tokens":
                out = self.model(t["ids"], t["mask"], q_token_id=self.bundle.q_token_id)
            else:
                out = self.model(t["node_feat"], t["adj"], t["mask"], etype=t.get("eadj"))
        return out.float().cpu().numpy()

    def _batched(self, rows: Dict[str, np.ndarray], n: int) -> np.ndarray:
        """Run n example rows through _apply in power-of-two row buckets."""
        outs = []
        i = 0
        while i < n:
            take = min(self.max_batch, n - i)
            b = _next_pow2(take, self.max_batch)
            batch = {}
            for k, v in rows.items():
                chunk = v[i:i + take]
                if b > take:
                    # pad with COPIES of the first row, not zeros: <bos>
                    # pooling is batch-global, so an all-<pad> filler row
                    # would flip the whole batch to masked-mean pooling
                    padrow = np.repeat(chunk[:1], b - take, axis=0)
                    chunk = np.concatenate([chunk, padrow], axis=0)
                batch[k] = chunk
            outs.append(self._apply(batch)[:take])
            i += take
        return np.concatenate(outs, axis=0) if outs else np.zeros((0,))

    # -- warmup ---------------------------------------------------------------

    def _proto_rows(self) -> Dict[str, np.ndarray]:
        """One representative input row, built through the real encoders."""
        g = Graph(edges=np.asarray([[0, 1]], np.int32), num_nodes=2,
                  y=0.0 if self.task == "zinc" else 0,
                  node_labels=np.zeros(2, np.int32),
                  edge_labels=np.ones(1, np.int32),
                  query_u=0, query_v=1)
        if self.model_name == "agtt":
            return self._encode_trail_rows([g])
        if self.model_name in ("mpnn", "ggps"):
            return self._encode_graph_rows([g])
        if self.task == "zinc":
            text = tokenize_zinc_molecule(
                g, max_len=int(self.serve["meta"]["max_len"]))
            return self._encode_token_rows([text])
        return self._encode_token_rows(["<bos> <eos>"])

    def warmup(self, batch_buckets: Optional[Sequence[int]] = None
               ) -> Dict[int, float]:
        """Run one forward per batch bucket (default: every power of two up
        to ``max_batch``), so the first request finds the kernel built and
        the allocator warm. Requested sizes round up to the bucket grid
        ``_batched`` uses. Returns {bucket: seconds}."""
        if batch_buckets is None:
            batch_buckets, b = [], 1
            while b <= self.max_batch:
                batch_buckets.append(b)
                b *= 2
        buckets = sorted({_next_pow2(int(b), self.max_batch)
                          for b in batch_buckets if b > 0})
        proto = self._proto_rows()
        timings: Dict[int, float] = {}
        for b in buckets:
            rows = {k: np.repeat(v, b, axis=0) for k, v in proto.items()}
            t0 = time.perf_counter()
            self._apply(rows)
            timings[int(b)] = round(time.perf_counter() - t0, 4)
        return timings

    # -- tokenization of raw inputs (same paths as training) ---------------

    def _encode_token_rows(self, texts: Sequence[str]) -> Dict[str, np.ndarray]:
        if self.vocab is None:
            raise ValueError("token-text prediction needs the checkpoint "
                             "vocab (ibtt checkpoints carry it)")
        bucket = int(self.serve["meta"]["max_len"])
        pad_id = int(self.serve["meta"].get("pad_id", self.vocab["<pad>"]))
        ids, lens = encode_texts(texts, self.vocab, max_len=bucket)
        n, l = ids.shape if ids.size else (len(texts), 0)
        out = np.full((n, bucket), pad_id, dtype=np.int32)
        if ids.size:
            out[:, :l] = ids
        mask = np.arange(bucket)[None, :] < lens[:, None]
        return {"ids": out, "mask": mask}

    def _trail_tokenizer(self):
        if self._tok is None:
            from .tokenization.sent import TrailTokenizer
            meta = self.serve["meta"]
            max_len = int(meta["max_len"])
            tok = TrailTokenizer(max_length=max_len, truncation_length=max_len,
                                 labeled_graph=self.task == "zinc",
                                 undirected=True)
            tok.set_num_nodes(int(meta["max_nodes"]))
            if self.task == "zinc":
                from .data.zinc import ZINC_NUM_ATOM_TYPES, ZINC_NUM_BOND_TYPES
                tok.set_num_node_and_edge_types(ZINC_NUM_ATOM_TYPES,
                                                ZINC_NUM_BOND_TYPES)
            self._tok = tok
        return self._tok

    def _encode_trail_rows(self, graphs: Sequence[Graph]) -> Dict[str, np.ndarray]:
        meta = self.serve["meta"]
        tok = self._trail_tokenizer()
        max_nodes = int(meta["max_nodes"])
        too_big = [g.num_nodes for g in graphs if g.num_nodes > max_nodes]
        if too_big:
            raise ValueError(
                f"graph with {max(too_big)} nodes exceeds this checkpoint's "
                f"position table ({max_nodes} nodes); retrain with a larger "
                "corpus or smaller graphs")
        fixed = build_fixed_zinc_vocab()[0] if self.task == "zinc" else None
        seqs = []
        for g in graphs:
            t = tok(g)
            if fixed is not None:
                t = tok.remap_zinc_tokens(t, fixed)
            if self.task in QUERY_TASKS and g.query_u is not None:
                t = tok.append_query(t, g.query_u,
                                     g.query_v if g.query_v is not None
                                     else g.query_u)
            seqs.append(t)
        bucket = int(meta["max_len"])
        pad_id = int(meta["pad_id"])
        seqs = [s[:bucket] for s in seqs]
        ids, mask = pad_sequences(seqs, pad_id=pad_id, max_len=bucket)
        n, l = ids.shape
        out = np.full((n, bucket), pad_id, dtype=np.int32)
        outm = np.zeros((n, bucket), dtype=bool)
        out[:, :l] = ids
        outm[:, :l] = mask
        return {"ids": out, "mask": outm}

    def _encode_graph_rows(self, graphs: Sequence[Graph]) -> Dict[str, np.ndarray]:
        """Dense padded rows at the checkpoint's node bucket: the node
        features, the adjacency as f32, the mask, and the edge types when
        the model reads them. A graph above the bucket is refused."""
        meta = self.serve["meta"]
        n_max = int(meta["n_max"])
        too_big = [g.num_nodes for g in graphs if g.num_nodes > n_max]
        if too_big:
            raise ValueError(
                f"graph with {max(too_big)} nodes exceeds this checkpoint's "
                f"node bucket ({n_max} nodes)")
        is_zinc = self.task == "zinc"
        graphs = [dataclasses.replace(g, y=0.0 if is_zinc else 0)
                  if g.y is None else g for g in graphs]
        gb = batch_graphs(
            graphs, n_max=n_max,
            node_feat_mode="labels" if is_zinc else "const",
            query_encoding=self.task in QUERY_TASKS,
            label_dtype=np.float32 if is_zinc else np.int32,
            edge_types=is_zinc)
        rows = {"node_feat": gb.node_feat.astype(np.float32),
                "adj": gb.adj.astype(np.float32),
                "mask": gb.node_mask}
        if self.model.edge_features and gb.eadj is not None:
            rows["eadj"] = gb.eadj.astype(np.int32)
        return rows

    # -- public API ---------------------------------------------------------

    def predict_texts(self, texts: Sequence[str]) -> Dict[str, np.ndarray]:
        """Predict from raw token-text records (ibtt). Everything after the
        first '<p>' is stripped before encoding, exactly like training."""
        if self.model_name != "ibtt":
            raise ValueError(f"{self.model_name} consumes graphs, not text; "
                             "use predict_graphs")
        rows = self._encode_token_rows(list(texts))
        return self._finish(self._batched(rows, len(texts)))

    def predict_graphs(self, graphs: Sequence[Graph]) -> Dict[str, np.ndarray]:
        """Predict from Graph inputs: SENT trails for agtt, dense batching
        for mpnn/ggps, the ZINC index tokenizer for ibtt-zinc."""
        graphs = list(graphs)
        if self.model_name == "agtt":
            rows = self._encode_trail_rows(graphs)
        elif self.model_name in ("mpnn", "ggps"):
            rows = self._encode_graph_rows(graphs)
        elif self.task == "zinc":  # ibtt on molecules -> index token text
            texts = [tokenize_zinc_molecule(
                dataclasses.replace(g, y=0.0) if g.y is None else g,
                max_len=int(self.serve["meta"]["max_len"]))
                for g in graphs]
            rows = self._encode_token_rows(texts)
        else:
            raise ValueError("ibtt on synthetic tasks consumes the token "
                             "text records; use predict_texts")
        return self._finish(self._batched(rows, len(graphs)))

    def _finish(self, logits: np.ndarray) -> Dict[str, np.ndarray]:
        if self.task == "zinc":
            return {"pred": logits.astype(np.float32)}
        z = logits - logits.max(axis=-1, keepdims=True)
        probs = np.exp(z) / np.exp(z).sum(axis=-1, keepdims=True)
        return {"pred": np.argmax(logits, axis=-1).astype(np.int32),
                "prob": probs.max(axis=-1), "logits": logits}


def predict_records(predictor: Predictor, records: Sequence[dict]) -> Dict[str, np.ndarray]:
    """Predict from loader-style example dicts ({'text': ..., ...}) using
    whichever input form the model consumes."""
    texts = [r["text"] for r in records]
    if predictor.model_name == "ibtt" and predictor.task != "zinc":
        return predictor.predict_texts(texts)
    from .data.text_grammar import text_record_to_graph
    graphs: List[Graph] = []
    for r in records:
        g = text_record_to_graph(r["text"], predictor.task,
                                 label=r.get("label"))
        if g is None:
            raise ValueError("record with no parseable graph")
        graphs.append(g)
    return predictor.predict_graphs(graphs)
