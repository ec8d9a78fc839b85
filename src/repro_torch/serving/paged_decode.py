"""Model-integrated paged decode: one token against the paged KV pool.

The port of ``repro/serving/paged_decode.py`` for the attention families
(dense, moe, vlm, audio), as the reference's: it refuses what the reference
asserts against, ssm and hybrid models and MoE stacks with leading dense
layers. A decode step is embed -> loop over layers [paged attention + mlp or
moe] -> unembed, reading pages the engine has promoted to the hot tier. Each layer's attention is the
paged-attention kernel (``kernels/paged_attention``): the CUDA kernel for
pools on the card, its plain version for pools on the CPU.

On the card a step is ~120 launches a layer, and enqueueing them takes longer
than the card takes to run them. ``DecodeGraphs`` captures the whole step as
one CUDA graph per batch shape and replays it: the same kernels in the same
order, one launch from the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import spans
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.layers import rms_norm
from repro_torch.tree import leaves


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    block_table: torch.Tensor     # the static inputs the graph reads
    lengths: torch.Tensor
    inputs: torch.Tensor
    logits: torch.Tensor          # the static output it writes
    held: Tuple[int, ...]         # data_ptr of every tensor it reads in place


class DecodeGraphs:
    """One engine's CUDA graphs of the decode step, one per batch shape.

    A graph is keyed by the block table's shape (B, max_pages) and the
    inputs' shape and dtype; everything else it bakes in (the windows, the
    scale, the page size, the weights, the pools) belongs to the engine. The
    first call for a key runs the step eagerly on a side stream (that call's
    result; every kernel loads there) and then captures it. Each later call
    copies the step's table, lengths and inputs into the graph's static
    buffers and replays it. The graphs share one memory pool.

    A graph reads the weights and the pools in place: where a tensor's
    address differs from the one captured, the call captures its key's graph
    anew in place of the old one. A graph is kept for each key seen and none
    is dropped: each holds its static buffers and its (B, V) logits, and the
    intermediates of all of them share the pool. ``captures`` and ``replays``
    count what the cache did, as do the counts ``graph_captures`` and
    ``graph_replays`` on ``decode.dispatch`` while spans record."""

    def __init__(self):
        self._graphs: Dict[tuple, _Graph] = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        self.captures = 0
        self.replays = 0

    def step(self, params, cfg: ArchConfig, k_pool, v_pool, block_table, lengths, inputs,
             opts) -> torch.Tensor:
        """This step's logits from the graph of its shape, captured first
        where the cache has none for it or its graph reads other tensors."""
        key = (block_table.shape, inputs.shape, inputs.dtype)
        held = (k_pool.data_ptr(), v_pool.data_ptr(), *(t.data_ptr() for t in leaves(params)))
        with torch.cuda.device(k_pool.device):
            g = self._graphs.get(key)
            if g is None or g.held != held:
                self._graphs.pop(key, None)
                return self._capture(key, held, params, cfg, k_pool, v_pool, block_table,
                                     lengths, inputs, opts)
            g.block_table.copy_(block_table)
            g.lengths.copy_(lengths)
            g.inputs.copy_(inputs)
            g.graph.replay()
        self.replays += 1
        spans.count("graph_replays")
        return g.logits

    def _capture(self, key, held, params, cfg, k_pool, v_pool, block_table, lengths, inputs,
                 opts) -> torch.Tensor:
        if self._stream is None:
            self._stream = torch.cuda.Stream()
            self._pool = torch.cuda.graph_pool_handle()
        main, side = torch.cuda.current_stream(), self._stream
        static = [t.clone() for t in (block_table, lengths, inputs)]
        side.wait_stream(main)
        with torch.cuda.stream(side):
            logits = _decode_body(params, cfg, k_pool, v_pool, *static, opts)
        main.wait_stream(side)
        logits.record_stream(main)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=side):
            out = _decode_body(params, cfg, k_pool, v_pool, *static, opts)
        self._graphs[key] = _Graph(graph, *static, out, held)
        self.captures += 1
        spans.count("graph_captures")
        return logits


def paged_decode_step(
    params,
    cfg: ArchConfig,
    k_pool: torch.Tensor,        # (L, slots, page, K, hd)
    v_pool: torch.Tensor,
    block_table: torch.Tensor,   # (B, max_pages) int32 hot slots
    lengths: torch.Tensor,       # (B,) int32
    inputs: torch.Tensor,        # (B, 1) tokens or (B, 1, D)
    opts: tf.ModelOptions = tf.ModelOptions(),
    *,
    graphs: Optional[DecodeGraphs] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (logits (B, V), k_pool, v_pool).

    Unlike the reference, whose ``lax.scan`` donates the pools and returns new
    ones, this writes the new token's K/V into ``k_pool``/``v_pool`` in place
    and returns the same tensors, so its signature is the reference's.

    With `graphs` and pools on the card, the step replays the graph of its
    shape (``DecodeGraphs``); the logits are then the graph's output buffer,
    valid until the next call with the same `graphs`. Otherwise it runs
    eagerly."""
    # The reference's two asserts, with its wording (hybrid_moe has no
    # counterpart there: its Mamba2 state has no place in the paged pools).
    if cfg.family in ("ssm", "hybrid", "hybrid_moe"):
        raise NotImplementedError("paged decode is for attention archs")
    if cfg.moe and cfg.moe_first_dense:
        raise NotImplementedError("use uniform stacks for paged demo")
    # host time from entry to return: every launch enqueued, no wait
    with spans.span("decode.dispatch"):
        if graphs is not None and k_pool.is_cuda:
            logits = graphs.step(params, cfg, k_pool, v_pool, block_table, lengths, inputs,
                                 opts)
        else:
            logits = _decode_body(params, cfg, k_pool, v_pool, block_table, lengths, inputs,
                                  opts)
    return logits, k_pool, v_pool


def _decode_body(params, cfg: ArchConfig, k_pool, v_pool, block_table, lengths, inputs,
                 opts) -> torch.Tensor:
    """The step's launches, eagerly: the logits (B, V)."""
    B = inputs.shape[0]
    L, slots, page, K, hd = k_pool.shape
    h = tf.embed_inputs(params, cfg, inputs)
    windows = tf.layer_windows(cfg, cfg.num_layers)
    positions = lengths[:, None].to(torch.int32)
    page_idx = (lengths // page).long()
    offset = (lengths % page).long()
    slot_of = block_table[torch.arange(B, device=block_table.device), page_idx].long()
    kv_lengths = lengths + 1
    scale = float(cfg.resolved_head_dim) ** -0.5
    for layer in range(L):
        p = tf._layer(params["stack"], layer)
        x = rms_norm(h, p["ln1"])
        q, k_new, v_new = attn._project_qkv(p["attn"], x, positions, cfg.rope_theta,
                                            cfg.qk_norm)
        # write the new token's K/V into its page slot (in place)
        k_pages, v_pages = k_pool[layer], v_pool[layer]
        k_pages[slot_of, offset] = k_new[:, 0].to(k_pages.dtype)
        v_pages[slot_of, offset] = v_new[:, 0].to(v_pages.dtype)
        out = paged_attention(q[:, 0].contiguous(), k_pages, v_pages, block_table,
                              kv_lengths, int(windows[layer]), scale=scale)
        a_out = torch.einsum("bnh,nhd->bd", out.to(x.dtype), p["attn"]["wo"])
        h, _ = tf._finish_block(p, h, a_out[:, None], cfg, opts.moe_impl)
    return tf.unembed(params, cfg, h)[:, 0]
