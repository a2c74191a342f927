"""SimpleTransformer: the shared IBTT/AGTT sequence model, in PyTorch.

Port of ``glearning_benchmark_tpu/models/transformer.py``: learned token +
absolute positional embeddings, a post-LN encoder stack (self-attention ->
add -> LayerNorm -> FFN(ReLU) -> add -> LayerNorm), <bos> pooling with a masked-mean fallback, the '<q> u v' query readout, and
the packed-row readout. Module and parameter names follow the flax ones
(``embed``, ``pos``, ``layer_{i}/{qkv,out_proj,ff1,ff2,norm1,norm2}``,
``norm``, ``cls``; ``layer_{i}/moe`` in place of ff1/ff2 with
``moe_experts``) so ``convert.py`` maps checkpoints mechanically.

Numerics follow flax: parameters are f32; the ``Dense`` layers inside the
encoder and the attention compute in ``compute_dtype``; residual sums and
LayerNorms (eps 1e-6, flax's default) run in f32; the readout runs in f32.
Attention always goes through :func:`..ops.flash_attention.flash_attention`
with the padding mask as segment ids (the JAX package's ``use_flash``
path): on a CUDA tensor those are the hand-written kernels, forward and
backward, on a CPU tensor their plain versions. Pad query rows then carry
zeros, which no readout reads.

Dropout runs only in ``train()`` mode, at the reference's four sites per
layer: on the attention probabilities inside the attention kernels (an
int32 seed per call), and by :func:`..ops.attention.cheap_dropout` after
``out_proj``, after the ReLU and after ``ff2``. The seeds of a forward are
drawn on the host from the ``torch.Generator`` the caller passes, before
any layer runs, so a checkpointed (``remat``) layer sees the same masks
when it is recomputed.

With ``moe_experts`` > 0 each layer's FFN is the Switch MoE FFN of
:mod:`.moe` (valid tokens: the key mask, ``seg > 0`` for packed rows),
whose expert hidden layer drops at ``p_drop`` with the ReLU site's seed;
its load-balance losses, one a layer, are appended to the list a training
forward is handed as ``aux``.

Under data parallelism a forward is handed its ``shard`` of the global
batch (``parallel.mesh.BatchShard``): every dropout mask is then the rows
of the global mask that the rank holds, so a run on N ranks draws the
masks of the same run on one process.

The other mesh axes, as the JAX package's ``sp_mesh``/``ep_mesh`` fields
and its parameter rule set them up:

- tensor parallelism: ``parallel.mesh.shard_params`` splits the ``Dense``
  and ``Embed`` features over 'model'; each sharded layer computes its
  columns and all-gathers them (``parallel/tp.py``), the rest runs
  replicated;
- sequence parallelism (``sp_mesh``, a mesh with a 'seq' axis): the encoder
  stack, from the embedding sum to the last layer, runs on the rank's
  contiguous L/s tokens, with :func:`..ops.ring_attention.ring_attention`
  in place of the flash kernels; its dropout masks are the token block of
  the global masks; the final hidden states are all-gathered over 'seq'
  before the readout, which needs every position. Packed rows are refused;
- expert parallelism: the MoE expert stacks split over 'expert' (the
  parameter rule), and with ``ep_mesh`` the manual all-to-all dispatch
  (:mod:`.moe`).

The pipeline (PP) runs these same layers in another schedule
(``parallel/pipeline.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import cheap_dropout
from ..ops.flash_attention import flash_attention
from ..ops.ring_attention import ring_attention, seq_block
from ..parallel.comm import all_gather
from ..parallel.tp import dense as _dense
from .moe import SwitchFFN

LN_EPS = 1e-6            # flax nn.LayerNorm default
_TRUNC_STD = 0.02        # flax truncated_normal(0.02): embed, pos, cls
_TRUNC_NORMAL_STD = 0.87962566103423978  # std of N(0,1) cut at +-2


def _trunc_normal_(t: torch.Tensor, std: float,
                   generator: Optional[torch.Generator]) -> None:
    nn.init.trunc_normal_(t, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)


def _lecun_normal_(lin: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """flax lecun_normal: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / lin.in_features) / _TRUNC_NORMAL_STD
    _trunc_normal_(lin.weight, std, generator)
    nn.init.zeros_(lin.bias)


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return norm(x.float())


class EncoderLayer(nn.Module):
    """Post-LN encoder layer (torch ``TransformerEncoderLayer`` semantics:
    norm_first=False, ReLU). ``p_attn`` drops attention probabilities,
    ``p_res`` the two [B, L, d] residual branches, ``p_ffn`` the
    [B, L, d_ff] activation; with ``moe_experts`` > 0 the FFN is a
    :class:`SwitchFFN` whose hidden layer drops at ``p_moe``."""

    def __init__(self, d_model: int, nhead: int, d_ff: int,
                 dtype: torch.dtype = torch.float32, p_attn: float = 0.0,
                 p_res: float = 0.0, p_ffn: float = 0.0, moe_experts: int = 0,
                 moe_capacity: float = 1.25, p_moe: float = 0.0, seq_axis=None,
                 ep_mesh=None):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"nhead {nhead}")
        self.nhead = nhead
        self.dtype = dtype
        self.p_attn, self.p_res, self.p_ffn = p_attn, p_res, p_ffn
        self.seq_axis = seq_axis
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.out_proj = nn.Linear(d_model, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        if moe_experts > 0:
            self.moe = SwitchFFN(d_model, d_ff, moe_experts, moe_capacity, p_moe, dtype,
                                 ep_mesh=ep_mesh, seq_axis=seq_axis)
        else:
            self.ff1 = nn.Linear(d_model, d_ff)
            self.ff2 = nn.Linear(d_ff, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        for lin in (self.qkv, self.out_proj):
            _lecun_normal_(lin, generator)
        if hasattr(self, "moe"):
            self.moe.reset_parameters(generator)
        else:
            _lecun_normal_(self.ff1, generator)
            _lecun_normal_(self.ff2, generator)
        for norm in (self.norm1, self.norm2):
            nn.init.ones_(norm.weight)
            nn.init.zeros_(norm.bias)

    def forward(self, x: torch.Tensor, seg: torch.Tensor,
                seeds: Optional[Sequence[int]] = None, shard=None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x [B, L, d] f32, seg [B, L] int32 (0 = pad) -> ([B, L, d] f32,
        the MoE aux loss of a training forward or None). ``seeds``
        (attention, out_proj, ReLU, ff2) turns dropout on; None is the
        deterministic forward. ``shard``: the rows' place in the global
        batch (module docstring). Sequence-parallel (``seq_axis``), x is
        this rank's token block and seg its key mask."""
        b, l, d = x.shape
        h = self.nhead
        s_attn, s_out, s_relu, s_ff2 = seeds if seeds is not None else (None,) * 4
        row0 = 0 if shard is None else shard.start
        seq = self.seq_axis
        # a sequence-parallel rank's masks are its token block of the global masks
        place = None if seq is None else {1: (seq.index * l, seq.size * l)}
        # q|k|v along the last axis (jnp.split order); each stays a strided
        # view of qkv, which the kernels read in place
        q, k, v = (t.unflatten(-1, (h, d // h))
                   for t in _dense(self.qkv, x, self.dtype).split(d, dim=-1))
        p_attn = self.p_attn if seeds is not None else 0.0
        if seq is not None:
            attn = ring_attention(seq, q, k, v, seg > 0, p_attn, s_attn, bh_offset=row0 * h)
        else:
            attn = flash_attention(q, k, v, seg=seg, p_drop=p_attn, seed=s_attn,
                                   bh_offset=row0 * h)
        attn = _dense(self.out_proj, attn.reshape(b, l, d), self.dtype)
        if seeds is not None:
            attn = cheap_dropout(s_out, attn, self.p_res, batch_offset=row0, place=place)
        x = _layer_norm(self.norm1, x + attn.float())
        aux = None
        if hasattr(self, "moe"):
            y, aux = self.moe(x.to(self.dtype), seg > 0, s_relu, shard)
        else:
            y = F.relu(_dense(self.ff1, x, self.dtype))
            if seeds is not None:
                y = cheap_dropout(s_relu, y, self.p_ffn, batch_offset=row0, place=place)
            y = _dense(self.ff2, y, self.dtype)
        if seeds is not None:
            y = cheap_dropout(s_ff2, y, self.p_res, batch_offset=row0, place=place)
        return _layer_norm(self.norm2, x + y.float()), aux


def transformer_embed(embed: nn.Embedding, pos_embed: nn.Embedding,
                      x: torch.Tensor, pos: Optional[torch.Tensor]) -> torch.Tensor:
    """Token + positional embedding prefix."""
    if pos is None:
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
    return embed(x) + pos_embed(pos)


def transformer_readout(norm, cls, h, x, attn_mask, *, task, use_query_nodes,
                        bos_id, query_offsets, q_token_id=None, seg=None,
                        pos_bos=None, pos_u=None, pos_v=None) -> torch.Tensor:
    """Pooling + classifier after the encoder stack.

    Unpacked rows (seg None): <bos> pooling when EVERY row of the batch
    starts with <bos> (a batch-global test, as in the reference), else the
    masked mean; the '<q>' readout takes u and v at ``query_offsets`` past
    the first '<q>' of each row, zeroed when that lies past the row's true
    length. Packed rows: host-computed per-slot gathers [B, K]."""
    d = h.shape[-1]
    if seg is not None:
        def take(idx):
            return torch.gather(h, 1, idx[:, :, None].expand(-1, -1, d).long())

        pooled = norm(take(pos_bos))
        if use_query_nodes:
            # slot 0 is always a segment's <bos>, so 0 means "no query"
            u = take(pos_u)
            v = take(pos_v)
            u = torch.where((pos_u > 0)[..., None], u, torch.zeros_like(u))
            v = torch.where((pos_v > 0)[..., None], v, torch.zeros_like(v))
            pooled = torch.cat([pooled, norm(u), norm(v)], dim=-1)
        out = cls(pooled)
        return out.squeeze(-1) if task == "zinc" else out

    l = x.shape[1]
    maskf = attn_mask.to(h.dtype)
    lens = maskf.sum(-1, keepdim=True).clamp(min=1.0)
    mean_emb = (h * maskf[..., None]).sum(1) / lens
    all_bos = torch.all(x[:, 0] == bos_id)
    bos_emb = torch.where(all_bos, h[:, 0], mean_emb)

    if use_query_nodes and q_token_id is not None:
        is_q = (x == q_token_id) & attn_mask
        found = is_q.any(dim=1)
        q_pos = is_q.to(torch.int32).argmax(dim=1)
        off_u, off_v = query_offsets
        row_len = attn_mask.sum(dim=1)
        in_range = found & (q_pos + off_v < row_len)
        rows = torch.arange(h.shape[0], device=h.device)
        u_emb = h[rows, (q_pos + off_u).clamp(0, l - 1)]
        v_emb = h[rows, (q_pos + off_v).clamp(0, l - 1)]
        keep = in_range[:, None]
        u_emb = torch.where(keep, u_emb, torch.zeros_like(u_emb))
        v_emb = torch.where(keep, v_emb, torch.zeros_like(v_emb))
        pooled = torch.cat([norm(bos_emb), norm(u_emb), norm(v_emb)], dim=-1)
    else:
        pooled = norm(bos_emb)
    out = cls(pooled)
    return out.squeeze(-1) if task == "zinc" else out


class SimpleTransformer(nn.Module):
    """Token transformer for IBTT and AGTT.

    ``generator`` seeds the initial parameters, which follow flax's inits
    in distribution: truncated normal (std 0.02, cut at 2 std) for
    ``embed``, ``pos`` and the ``cls`` kernel; lecun-normal for the other
    ``Dense`` kernels; zero biases; LayerNorm scale 1, bias 0.

    ``p_drop`` is the rate of all four dropout sites of a layer;
    ``attn_p_drop`` / ``mlp_p_drop`` split the attention-probability site
    from the other three, ``resid_p_drop`` / ``ffn_p_drop`` split those
    into the two residual sites and the FFN-inner site (None: inherit).
    ``remat`` recomputes each encoder layer in the backward pass instead of
    keeping its activations. ``moe_experts`` > 0 makes every layer's FFN a
    Switch MoE FFN of that many experts at capacity factor
    ``moe_capacity``. ``sp_mesh`` (a mesh with a 'seq' axis) makes the
    encoder stack sequence-parallel; ``ep_mesh`` (a ('data', 'expert')
    mesh) gives the MoE FFNs the manual all-to-all dispatch (module
    docstring)."""

    def __init__(self, vocab_size: int, d_model: int = 256, nhead: int = 8,
                 nlayers: int = 4, d_ff: int = 512, p_drop: float = 0.1,
                 max_pos: int = 4096, num_classes: int = 2,
                 use_query_nodes: bool = True, task: str = "cycle_check",
                 bos_id: int = 1, query_offsets: Tuple[int, int] = (2, 3),
                 compute_dtype: str = "float32", remat: bool = False,
                 attn_p_drop: Optional[float] = None,
                 mlp_p_drop: Optional[float] = None,
                 resid_p_drop: Optional[float] = None,
                 ffn_p_drop: Optional[float] = None,
                 moe_experts: int = 0, moe_capacity: float = 1.25,
                 sp_mesh=None, ep_mesh=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                             f"got {compute_dtype!r}")
        self.d_model = d_model
        self.nlayers = nlayers
        self.p_drop = p_drop
        self.remat = remat
        self.task = task
        self.use_query_nodes = use_query_nodes
        self.bos_id = bos_id
        self.query_offsets = tuple(query_offsets)
        self.compute_dtype = compute_dtype
        self.moe_experts = moe_experts
        self.sp_mesh = sp_mesh
        self.seq_axis = None if sp_mesh is None else sp_mesh.axis("seq")
        cdtype = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
        self.embed = nn.Embedding(vocab_size, d_model)
        self.pos = nn.Embedding(max_pos, d_model)
        p_attn = p_drop if attn_p_drop is None else attn_p_drop
        p_mlp = p_drop if mlp_p_drop is None else mlp_p_drop
        p_res = p_mlp if resid_p_drop is None else resid_p_drop
        p_ffn = p_mlp if ffn_p_drop is None else ffn_p_drop
        self.has_dropout = max(p_attn, p_res, p_ffn,
                               p_drop if moe_experts > 0 else 0.0) > 0.0
        for i in range(nlayers):
            self.add_module(f"layer_{i}",
                            EncoderLayer(d_model, nhead, d_ff, cdtype,
                                         p_attn, p_res, p_ffn, moe_experts,
                                         moe_capacity, p_drop, self.seq_axis, ep_mesh))
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        readout_width = 3 * d_model if use_query_nodes else d_model
        self.cls = nn.Linear(readout_width, num_classes)
        self.reset_parameters(generator)

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.nlayers)]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _trunc_normal_(self.embed.weight, _TRUNC_STD, generator)
        _trunc_normal_(self.pos.weight, _TRUNC_STD, generator)
        for layer in self.layers():
            layer.reset_parameters(generator)
        nn.init.ones_(self.norm.weight)
        nn.init.zeros_(self.norm.bias)
        _trunc_normal_(self.cls.weight, _TRUNC_STD, generator)
        nn.init.zeros_(self.cls.bias)

    def forward(self, x: torch.Tensor, attn_mask: torch.Tensor,
                q_token_id: Optional[int] = None,
                seg: Optional[torch.Tensor] = None,
                pos: Optional[torch.Tensor] = None,
                pos_bos: Optional[torch.Tensor] = None,
                pos_u: Optional[torch.Tensor] = None,
                pos_v: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                shard=None, aux: Optional[list] = None) -> torch.Tensor:
        """x [B, L] int token ids, attn_mask [B, L] bool. Unpacked rows
        (seg None) return [B, C] ([B] for zinc); packed rows (seg [B, L]
        segment ids with within-segment ``pos`` and readout slots
        ``pos_bos``/``pos_u``/``pos_v`` [B, K]) return [B, K, C].
        In ``train()`` mode with a non-zero dropout rate, ``generator`` (a
        CPU generator) gives the forward's dropout seeds. ``shard`` places
        the rows in the global batch (data parallelism); a training forward
        of an MoE model appends its layers' aux losses to ``aux``."""
        seq = self.seq_axis
        if seq is not None:
            if seg is not None:
                raise ValueError("sequence-parallel ring attention does not "
                                 "support packed rows (disable dataset.pack)")
            # this rank's contiguous block of tokens, at its global positions
            ls = seq_block(x.shape[1], seq)
            lo = seq.index * ls
            h = transformer_embed(self.embed, self.pos, x[:, lo:lo + ls],
                                  torch.arange(lo, lo + ls, device=x.device)[None, :])
            seg_ids = attn_mask[:, lo:lo + ls].to(torch.int32).contiguous()
        else:
            h = transformer_embed(self.embed, self.pos, x, pos)
            seg_ids = (attn_mask if seg is None else seg).to(torch.int32).contiguous()
        seeds = [None] * self.nlayers
        if self.training and self.has_dropout:
            if generator is None:
                raise ValueError("a training forward with dropout needs the "
                                 "generator its seeds are drawn from")
            # one host draw for the whole forward: (attention, out_proj,
            # ReLU, ff2) per layer, int32-ranged like the reference's
            # randint(0, int32 max)
            seeds = torch.randint(0, 2**31 - 1, (self.nlayers, 4),
                                  generator=generator).tolist()
        for layer, layer_seeds in zip(self.layers(), seeds):
            if self.remat and torch.is_grad_enabled():
                h, layer_aux = checkpoint(layer, h, seg_ids, layer_seeds, shard,
                                          use_reentrant=False)
            else:
                h, layer_aux = layer(h, seg_ids, layer_seeds, shard)
            if layer_aux is not None and aux is not None:
                aux.append(layer_aux)
        if seq is not None:
            h = all_gather(h, seq, 1)
        return transformer_readout(
            lambda t: _layer_norm(self.norm, t), self.cls, h, x, attn_mask,
            task=self.task, use_query_nodes=self.use_query_nodes,
            bos_id=self.bos_id, query_offsets=self.query_offsets,
            q_token_id=q_token_id, seg=seg, pos_bos=pos_bos, pos_u=pos_u,
            pos_v=pos_v)
