"""Serving steps: prefill (a full-sequence forward producing the KV cache)
and decode (one token a row against the cache), plus the slot primitives
of the continuous-batching tier — counterpart of
`repro/distributed/serve_step.py`.

The reference jits each step under a mesh's shardings and donates the
cache; here there is no mesh and no compile.  Each `make_*` returns a plain
step function that runs on the device its arguments lie on, under
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

On the card a rung's decode step is replayed as a CUDA graph
(`GraphedDecode`), the port's counterpart of the reference's compiled
executable: the params and the resident cache never move, so the graph
reads and writes them in place, and only the step's token and position
vectors are copied in.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops


def make_decode_step(model, *, ring: bool = False):
    """`step(params, cache, tokens (b,), pos) -> (logits (b, vocab), cache)`;
    pos is a scalar or a (b,) tensor of per-row positions.  The cache is
    updated in place and returned."""

    @torch.inference_mode()
    def step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos, ring=ring)

    return step


def make_prefill(model):
    """`run(params, batch) -> (last-token logits (b, vocab), caches)`,
    batch = {"tokens": (b, t)} on the params' device, with a vision
    config's "patch_embeds" or an audio config's "frames" beside them."""

    @torch.inference_mode()
    def run(params, batch):
        return model.prefill(params, batch)

    return run


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
        if (s.data_ptr() != f.data_ptr() or s.shape[0] != n
                or s.shape[1:] != f.shape[1:] or s.stride() != f.stride()):
            raise ValueError("update_slots: the sub-cache is not a view of "
                             f"rows [0, {n}) of the resident buffer")
    return full


def move_slot(cache: list, src: int, dst: int) -> list:
    """Copy slot row `src` over slot row `dst`, in place (compaction after
    a request completes: the highest active slot backfills the freed
    one)."""
    with torch.inference_mode():
        for x in _leaves(cache):
            x[dst].copy_(x[src])
    return cache


def reset_slot(cache: list, slot: int) -> list:
    """Zero slot row `slot` in place (admission)."""
    with torch.inference_mode():
        for x in _leaves(cache):
            x[slot].zero_()
    return cache


def make_slot_decode_step(model, *, max_slots: int):
    """Rung-sliced decode over a resident slot cache (DESIGN §11).

    The cache is allocated once at the top rung (`max_slots` rows).
    `wrap(b)` returns the step of rung `b`: decode one token a row over
    rows [0, b) at PER-SLOT positions (each in-flight request lives on its
    own timeline) and pick the next token greedily:
    `step(params, cache, tokens (b,), pos (b,)) -> (next_tok (b,) int32,
    cache)`.  A rung change re-slices the same buffer; no cache byte
    moves."""

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
