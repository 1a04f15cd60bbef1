"""Serving steps: prefill (a full-sequence forward producing the KV cache)
and decode (one token a row against the cache), plus the slot primitives
of the continuous-batching tier — counterpart of
`repro/distributed/serve_step.py`.

The reference jits each step under a mesh's shardings and donates the
cache; here there is no compile.  Each `make_*` returns a plain step
function that runs on the device its arguments lie on, under
`torch.inference_mode()` (so the forward-only kernels, `rmsnorm` and
`flash_attention`, run on the card), and the cache is ONE resident buffer
written in place:

* `slice_slots` returns views of the first n slot rows, so a rung step's
  decode writes straight into the resident buffer;
* `update_slots` is then a no-op that checks it was handed those views
  (a copy would mean the step's writes were lost);
* `move_slot` and `reset_slot` copy and zero slot rows in place.

The cache is the model's per-layer list of {"k", "v"} (every leaf
(slots, length, kv_heads, head_dim)); for an MLA layer {"c_kv", "k_rope"}
(leaves (slots, length, rank)); for a recurrent layer its state, which has
no time axis (RG-LRU's {"h": (slots, width), "conv": (slots, k - 1,
width)}, SSD's {"ssm": (slots, heads, state, head_dim), "conv"}); an
encoder-decoder layer's also holds "cross_k" and "cross_v" (slots, frames,
kv_heads, head_dim), the reference's `cross_prefix` / `cross_scanned`.
The slot axis is 0 throughout, and the slot operations touch every leaf
whatever its layer kind: compaction moves a row's recurrent state with its
KV rows, and admission zeroes it (a fresh carry).  A recurrent decode
writes its new state into the views, like attention's KV writes.

On a mesh (`mesh=`, one process a rank, `launch/mesh.py`) each step runs
under `use_sharding_rules(_serve_rules(mesh, batch), mesh)` and takes this
rank's slices: the params' by `param_pspecs(fsdp=False)`, the cache's by
`cache_pspecs` over `model` (kv heads, latent and recurrent widths, or a
long cache's positions) and by rows over the data axes.  The builders then
return the reference's tuples: `(wrap, p_specs)`, and for the slot step
`(wrap, p_specs, cache_specs)`, `wrap` taking the whole cache's shapes
(`cache_like`, e.g. `model.init_cache(..., device="meta")`).  Logits come
out whole on every rank.  A batch that does not divide the data axes is
whole on every data rank, as the reference's `_serve_rules` replicate it.
Rows are a contiguous block a data rank for the fixed-batch steps (the
reference's `P(daxes)`); the slot pool spreads its slots over the data
ranks in turn (`slot_home`: slot s on data rank s mod J as its row s div
J), so a rung b touches rows [0, ceil((b - j) / J)) on data rank j
(`rung_rows`), and compaction and admission name global slots that may
live on another data rank.

On the card a rung's decode step is replayed as a CUDA graph
(`GraphedDecode`), the port's counterpart of the reference's compiled
executable: the params and the resident cache never move, so the graph
reads and writes them in place, and only the step's token and position
vectors are copied in.  A step on a model axis of more than one rank runs
eagerly: its gloo all-reduces are host-staged and cannot be captured.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.params import (
    cache_pspecs, gather_tree, param_pspecs, shard_tree)
from repro_torch.distributed.sharding import (
    DEFAULT_RULES, MULTIPOD_RULES, ShardingRules, entry_axes, use_sharding_rules)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import MODEL, data_peer, num_workers, worker_index
from repro_torch.tree import tree_map


def _serve_rules(mesh, batch: int) -> ShardingRules:
    base = MULTIPOD_RULES if "pod" in mesh.axis_names else DEFAULT_RULES
    if batch % num_workers(mesh) != 0:
        # batch not shardable over the data axes (long_500k b=1): replicate it
        return ShardingRules(rules={**base.rules, "batch": None})
    return base


def layer_seq_shards(c_specs) -> tuple[bool, ...]:
    """Per layer of a cache's specs, whether its attention or MLA cache
    lies over `model` by its time axis (dim 1)."""
    return tuple(any(k in ("k", "c_kv") and MODEL in entry_axes(spec[1])
                     for k, spec in layer.items()) for layer in c_specs)


def local_cache(cache_like, c_specs, mesh, device, rows: int | None = None):
    """A zeroed cache in this rank's layout on `device`: the slices
    `c_specs` give it of the whole cache `cache_like` (meta tensors will
    do) over every mesh axis, or, given `rows`, over `model` only with
    `rows` slot rows (the slot pool's own spread over the data ranks)."""
    if rows is not None:
        cache_like = [{k: x[:rows] for k, x in layer.items()} for layer in cache_like]
        like = shard_tree(cache_like, c_specs, mesh, axes=(MODEL,))
    else:
        like = shard_tree(cache_like, c_specs, mesh)
    return tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype, device=device), like)


def param_slices(params, p_specs, mesh):
    """This rank's slices of whole params, each its own contiguous tensor
    (the whole leaves themselves where the specs leave them whole)."""
    return tree_map(lambda x: x.contiguous(), shard_tree(params, p_specs, mesh))


def data_rows(n: int, mesh) -> slice:
    """This rank's rows of a fixed batch of n: a contiguous block over the
    data axes, or all of them when n does not divide them."""
    J = num_workers(mesh)
    if n % J:
        return slice(None)
    j = worker_index(mesh)
    return slice(j * n // J, (j + 1) * n // J)


def make_decode_step(model, mesh=None, *, batch: int | None = None,
                     ring: bool = False):
    """No mesh: `step(params, cache, tokens (b,), pos) -> (logits (b,
    vocab), cache)`; pos is a scalar or a (b,) tensor of per-row positions.
    The cache is updated in place and returned.

    On `mesh`: `(wrap, p_specs)`, `wrap(cache_like)` the same step over
    this rank's params, cache and rows of a batch of `batch` (module
    docstring), its logits whole."""
    if mesh is None:
        @torch.inference_mode()
        def step(params, cache, tokens, pos):
            return model.decode_step(params, cache, tokens, pos, ring=ring)

        return step

    rules = _serve_rules(mesh, batch)
    batch_ok = batch % num_workers(mesh) == 0

    def wrap(cache_like):
        seq = layer_seq_shards(cache_pspecs(cache_like, mesh, batch_divisible=batch_ok))

        @torch.inference_mode()
        def step(params, cache, tokens, pos):
            with use_sharding_rules(rules, mesh):
                return model.decode_step(params, cache, tokens, pos, ring=ring,
                                         seq_shards=seq)

        return step

    return wrap, param_pspecs(model.init(device="meta"), mesh, fsdp=False)


def make_prefill(model, mesh=None, *, batch: int | None = None):
    """No mesh: `run(params, batch) -> (last-token logits (b, vocab),
    caches)`, batch = {"tokens": (b, t)} on the params' device, with a
    vision config's "patch_embeds" or an audio config's "frames" beside
    them.

    On `mesh`: `(wrap, p_specs)`, `wrap(batch_like)` the same run over
    this rank's params and rows of a batch of `batch` rows, its logits
    whole and its caches in `cache_pspecs`'s layout."""
    if mesh is None:
        @torch.inference_mode()
        def run(params, batch):
            return model.prefill(params, batch)

        return run

    rules = _serve_rules(mesh, batch)

    def wrap(batch_like=None):
        @torch.inference_mode()
        def run(params, batch):
            with use_sharding_rules(rules, mesh):
                return model.prefill(params, batch)

        return run

    return wrap, param_pspecs(model.init(device="meta"), mesh, fsdp=False)


# ------------------------------------------------- resident slot caches ----

def _leaves(cache):
    return [x for layer in cache for _, x in sorted(layer.items())]


def slice_slots(cache: list, n: int) -> list:
    """The first `n` slot rows of every cache leaf, as VIEWS of the
    resident buffer."""
    return [{k: x[:n] for k, x in layer.items()} for layer in cache]


def update_slots(full: list, sub: list, n: int) -> list:
    """Rows [0, n) of the resident buffer after a rung step.  The step
    wrote through the views of `slice_slots`, so nothing is copied; this
    checks that `sub` is exactly those views and returns `full`."""
    for f, s in zip(_leaves(full), _leaves(sub), strict=True):
        # the same storage and start, read without a data pointer (the step
        # may run on fake tensors, `analysis/graph_check.py`)
        if (s.untyped_storage()._cdata != f.untyped_storage()._cdata
                or s.storage_offset() != f.storage_offset() or s.shape[0] != n
                or s.shape[1:] != f.shape[1:] or s.stride() != f.stride()):
            raise ValueError("update_slots: the sub-cache is not a view of "
                             f"rows [0, {n}) of the resident buffer")
    return full


def slot_home(slot: int, spread: int) -> tuple[int, int]:
    """(data index, row) of global slot `slot` when the pool spreads its
    slots over `spread` data ranks in turn."""
    return slot % spread, slot // spread


def rung_rows(b: int, spread: int, j: int) -> int:
    """How many of a rung's slots [0, b) live on data rank j."""
    return max(0, -(-(b - j) // spread))


def _spread(mesh) -> tuple[int, int]:
    """(J, j) of the data ranks the slots spread over (1, 0: no mesh)."""
    return (1, 0) if mesh is None else (num_workers(mesh), worker_index(mesh))


def move_slot(cache: list, src: int, dst: int, mesh=None) -> list:
    """Copy slot row `src` over slot row `dst`, in place (compaction after
    a request completes: the highest active slot backfills the freed
    one).  With `mesh`, the slots are spread over its data ranks
    (`slot_home`) and every rank of the mesh calls this in lockstep: a row
    that changes rank is broadcast over the data group from its rank."""
    J, j = _spread(mesh)
    (js, rs), (jd, rd) = slot_home(src, J), slot_home(dst, J)
    with torch.inference_mode():
        if js == jd:
            if j == js:
                for x in _leaves(cache):
                    x[rd].copy_(x[rs])
            return cache
        root = data_peer(mesh, js)
        for x in _leaves(cache):
            row = x[rs].contiguous() if j == js else torch.empty_like(x[0])
            dist.broadcast(row, src=root, group=mesh.data_group)
            if j == jd:
                x[rd].copy_(row)
    return cache


def reset_slot(cache: list, slot: int, mesh=None) -> list:
    """Zero slot row `slot` in place (admission); with `mesh`, on the data
    rank the slot lives on (`slot_home`)."""
    J, j = _spread(mesh)
    home, row = slot_home(slot, J)
    if j == home:
        with torch.inference_mode():
            for x in _leaves(cache):
                x[row].zero_()
    return cache


def gather_slots(cache: list, c_specs, mesh) -> list:
    """The whole resident pool on every rank, slots in global order: each
    leaf gathered over `model` (`c_specs`), then the data ranks' rows
    interleaved back (`slot_home`) when the specs spread them (a pool
    whose slots do not divide the data axes is whole on every data rank).
    Every rank of the mesh calls it."""
    whole = gather_tree(cache, c_specs, mesh, axes=(MODEL,))
    first = next(spec for layer in c_specs for spec in layer.values())
    J = num_workers(mesh) if entry_axes(first[0]) else 1

    def rows(x):
        parts = [torch.empty_like(x) for _ in range(J)]
        dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
        return torch.stack(parts, dim=1).reshape(-1, *x.shape[1:])

    return tree_map(rows, whole) if J > 1 else whole


def make_slot_decode_step(model, mesh=None, *, max_slots: int):
    """Rung-sliced decode over a resident slot cache (DESIGN §11).

    The cache is allocated once at the top rung (`max_slots` rows).
    `wrap(b)` returns the step of rung `b`: decode one token a row over
    rows [0, b) at PER-SLOT positions (each in-flight request lives on its
    own timeline) and pick the next token greedily:
    `step(params, cache, tokens (b,), pos (b,)) -> (next_tok (b,) int32,
    cache)`.  A rung change re-slices the same buffer; no cache byte
    moves.

    On `mesh`: `(wrap, p_specs, cache_specs)`; `cache_specs(cache_like)`
    the whole pool's specs, and `wrap(b, cache_like)` the step over this
    rank's params and its `rung_rows` rows of rung b, whose tokens and
    positions it takes and whose next tokens it returns (none on a data
    rank that holds none of the rung's slots).  When max_slots does not
    divide the data axes the pool is whole on every data rank."""
    if mesh is None:
        def wrap(b: int):
            if not 1 <= b <= max_slots:
                raise ValueError(f"rung {b} outside resident pool [1, {max_slots}]")

            @torch.inference_mode()
            def step(params, cache, tokens, pos):
                sub = slice_slots(cache, b)
                logits, new_sub = model.decode_step(params, sub, tokens, pos)
                next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
                return next_tok, update_slots(cache, new_sub, b)

            return step

        return wrap

    rules = _serve_rules(mesh, max_slots)
    batch_ok = max_slots % num_workers(mesh) == 0
    J, j = _spread(mesh) if batch_ok else (1, 0)

    def cache_specs(cache_like):
        return cache_pspecs(cache_like, mesh, batch_divisible=batch_ok)

    def wrap(b: int, cache_like):
        if not 1 <= b <= max_slots:
            raise ValueError(f"rung {b} outside resident pool [1, {max_slots}]")
        n = rung_rows(b, J, j)
        seq = layer_seq_shards(cache_specs(cache_like))

        @torch.inference_mode()
        def step(params, cache, tokens, pos):
            if n == 0:
                return torch.zeros(0, dtype=torch.int32, device=tokens.device), cache
            sub = slice_slots(cache, n)
            with use_sharding_rules(rules, mesh):
                logits, new_sub = model.decode_step(params, sub, tokens, pos,
                                                    seq_shards=seq)
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
            return next_tok, update_slots(cache, new_sub, n)

        return step

    return wrap, param_pspecs(model.init(device="meta"), mesh, fsdp=False), cache_specs


class GraphedDecode:
    """A slot decode step (`make_slot_decode_step(...)(b)`) captured once as
    a CUDA graph over the resident cache and replayed every step.

    Static inputs: `tokens` and `pos` ((b,) int32 on the card); static
    output: the step's next tokens ((b,) int32), overwritten by the next
    replay, so a caller reads it (or copies it) first.  A call takes the
    step's arguments: the params and the cache must be the ones it was
    captured over (they are fixed in place); tokens and pos come from the
    host through pinned buffers without blocking, or from the card.

    Before capture the step runs once on the capture stream against
    scratch rows shaped like the cache's first b (first-use work: cuBLAS
    handles and workspaces, kernel libraries), so no live request's row is
    written; those launches are real and counted.  Capture records the
    kernel wrappers' launches (`ops.capturing`), and each replay adds them
    to `ops.launch_counts()`.  A capture that fails raises: the step never
    runs eagerly instead.  `pool` is a graph memory pool shared by the
    rungs of one engine (one rung runs at a time); `stream` the capture
    stream."""

    def __init__(self, step, params, cache, b: int, *, pool=None, stream=None):
        device = next(x for layer in cache for x in layer.values()).device
        if device.type != "cuda":
            raise ValueError(f"GraphedDecode: a CUDA graph needs the card, "
                             f"the cache lies on {device}")
        self.b, self.params, self.cache = b, params, cache
        self.tokens = torch.zeros(b, dtype=torch.int32, device=device)
        self.pos = torch.zeros(b, dtype=torch.int32, device=device)
        self._host = torch.zeros(2, b, dtype=torch.int32).pin_memory()
        self._copied = None      # the last host-to-card copy's event
        stream = stream or torch.cuda.Stream(device)
        with torch.cuda.device(device):
            scratch = [{k: torch.zeros_like(x[:b]) for k, x in layer.items()}
                       for layer in cache]
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                step(params, scratch, self.tokens, self.pos)
            stream.synchronize()
            del scratch
            graph = torch.cuda.CUDAGraph()
            with ops.capturing() as captured:
                with torch.cuda.graph(graph, pool=pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    self.next_tok, _ = step(params, cache, self.tokens, self.pos)
        self.graph = ops.CountedGraph(graph, captured)

    def __call__(self, params, cache, tokens, pos):
        """`step(params, cache, tokens (b,), pos (b,)) -> (next_tok, cache)`,
        the eager step's signature."""
        if params is not self.params or cache is not self.cache:
            raise ValueError("GraphedDecode: called with other params or "
                             "another cache than it was captured over")
        staged = tokens.device.type != "cuda" or pos.device.type != "cuda"
        if staged and self._copied is not None:
            self._copied.synchronize()       # the staging rows are free again
        for row, (dst, src) in enumerate(((self.tokens, tokens), (self.pos, pos))):
            if src.device.type == "cuda":
                dst.copy_(src)
            else:
                self._host[row].copy_(src)
                dst.copy_(self._host[row], non_blocking=True)
        if staged:
            self._copied = torch.cuda.Event()
            self._copied.record()
        self.graph.replay()
        return self.next_tok, cache
