"""Open-addressing join table: the port of ``repro/kernels/hash_probe.py``.

``build_table`` inserts (key, value) rows into a power-of-two table by the
reference's round-synchronous linear probing; ``hash_probe`` looks keys up
in it (single match) and ``hash_probe_multi`` returns every match of each
key up to a capacity (the expansion probe). For a CUDA tensor each launches its kernels in
``csrc/hash_table.cu`` (the hash and the probe loop are in
``csrc/hash_probe.cuh``, which the fused morsel kernel shares; the source
says what bounds them and how the build reaches the reference's table
without its rounds: a compaction, a radix sort by home, a scan of the
levels and a walk of each cluster, in a number of launches fixed by the
shape, with no read-back). A build of ``n >= table_size`` rows, which can
fill the table, takes the round kernels instead (a shape rule: the
planner sizes tables at twice the rows). For a CPU tensor each runs its
plain PyTorch version, which repeats the reference's arithmetic step by
step.

``longest_run`` and ``probe_bound`` size a probe's ``max_probes`` from a
built table with a few torch operations on the table's device; only the
scalar comes back to the host.

Under ``launch.roofline.count_program`` each call reports 8 operations a
row or key (a hash and a compare) and these bytes, for n rows or keys and
T slots: ``build_table`` ``8 n + 8 T`` (every row's key and value read,
the table written once) plus n for a validity; ``hash_probe`` ``9 n +
min(8 T, 64 n)`` (the keys in, found and value out, and the table's key
and value arrays read at most once, at most a 32-byte sector of each a
key); ``hash_probe_multi`` ``n (8 + 4 m) + min(8 T, 64 n)`` (the counts
and the ``m`` slots a key out). Rows 6, 6b and 7's bounds in ``PERF.md``
count the sectors that the valid rows and the keys' runs touch, which a
count on ``meta`` cannot see, so the count reads every row and takes a
key's run as one sector.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ops

_LIB = "hash_table"
MAX_PROBES_DEFAULT = 64
_INT32_MAX = 2 ** 31 - 1
# (keys, vals, valid, n, table_size, empty_key, tk, tv, scratch,
#  scratch_bytes, stream)
_BUILD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p]
# (keys, vals, placed, n, table_size, empty_key, tk, tv, winner, unplaced,
#  stream): the round build, for n >= table_size
_ROUNDS_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p]
# (tk, tv, table_size, max_probes, empty_key, keys, n, found, vals, stream)
_PROBE_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
# (tk, tv, table_size, max_probes, empty_key, keys, n, max_matches, count,
#  slots, stream)
_PROBE_MULTI_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_void_p]


def hash_home(keys: torch.Tensor, table_size: int) -> torch.Tensor:
    """Home slot of each key (int64): the reference's ``_hash`` (uint32
    ``x ^= x >> 16; x *= 0x85EBCA6B; x ^= x >> 13``), computed in int64
    with ``& 0xFFFFFFFF``, masked to ``table_size - 1``."""
    x = keys.to(torch.int64) & 0xFFFFFFFF
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x = x ^ (x >> 13)
    return x & (table_size - 1)


def _check_table_size(table_size: int) -> None:
    if table_size < 1 or table_size & (table_size - 1) or table_size > 1 << 30:
        raise ValueError(f"table size {table_size} is not a power of two "
                         "in [1, 2^30]")


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def build_table_plain(keys: torch.Tensor, vals: torch.Tensor, table_size: int,
                      empty_key: int = -1, valid: torch.Tensor = None):
    """Plain version of ``build_table``: the reference's rounds, each a
    ``scatter_reduce(..., "amin")`` of the bidding row indices onto their
    slots, over the rows still unplaced."""
    _check_table_size(table_size)
    dev = keys.device
    n = keys.shape[0]
    tk = torch.full((table_size,), empty_key, dtype=torch.int32, device=dev)
    tv = torch.zeros(table_size, dtype=torch.int32, device=dev)
    if n == 0:
        return tk, tv
    keys = keys.to(torch.int32)
    vals = vals.to(torch.int32)
    home = hash_home(keys, table_size)
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    if valid is not None:
        rows = rows[valid]
    mask = table_size - 1
    winner = torch.full((table_size,), n, dtype=torch.int64, device=dev)
    i = 0
    while rows.numel() and i < table_size:
        slot = (home.index_select(0, rows) + i) & mask
        want = tk.index_select(0, slot) == empty_key
        bid = torch.where(want, rows, n)
        winner.fill_(n)
        winner.scatter_reduce_(0, slot, bid, "amin")
        won = want & (winner.index_select(0, slot) == rows)
        dst, src = slot[won], rows[won]
        tk[dst] = keys.index_select(0, src)
        tv[dst] = vals.index_select(0, src)
        rows = rows[~won]
        i += 1
    return tk, tv


def _table_bytes(table_keys, n: int) -> int:
    return min(8 * table_keys.shape[0], 64 * n)


def build_table_work(keys, vals, table_size, empty_key=-1, valid=None):
    """(operations, bytes) of one call: the closed form in the module's
    docstring."""
    n = keys.shape[0]
    return 8 * n, 8 * n + 8 * table_size + (n if valid is not None else 0)


def hash_probe_work(table_keys, table_vals, probe_keys, empty_key=-1,
                    max_probes=None):
    """(operations, bytes) of one call: the closed form in the module's
    docstring."""
    n = probe_keys.shape[0]
    return 8 * n, 9 * n + _table_bytes(table_keys, n)


def hash_probe_multi_work(table_keys, table_vals, probe_keys, max_matches,
                          empty_key=-1, max_probes=None):
    """(operations, bytes) of one call: the closed form in the module's
    docstring."""
    n = probe_keys.shape[0]
    return 8 * n, n * (8 + 4 * max_matches) + _table_bytes(table_keys, n)


@ops.reports("build_table", build_table_work)
def build_table(keys: torch.Tensor, vals: torch.Tensor, table_size: int,
                empty_key: int = -1, valid: torch.Tensor = None):
    """Insert (key, val) rows into an open-addressing table of
    ``table_size`` slots (a power of two) -> ``(table_keys, table_vals)``,
    int32[table_size] each, empty slots holding ``empty_key`` and 0.

    Rows with ``valid`` False are never placed. A row whose key equals
    ``empty_key`` is placed but leaves its slot looking empty; callers
    detect it by comparing occupied slots with valid rows."""
    ops.mark_kernel("build")
    if not keys.is_cuda:
        return build_table_plain(keys, vals, table_size, empty_key, valid)
    _check_table_size(table_size)
    n = keys.shape[0]
    if keys.dim() != 1 or vals.shape != keys.shape:
        raise ValueError(f"build_table: wants two 1-D tensors of one length, "
                         f"got {tuple(keys.shape)} and {tuple(vals.shape)}")
    if keys.dtype != torch.int32 or vals.dtype != torch.int32:
        raise TypeError(f"build_table: wants int32 keys and values, got "
                        f"{keys.dtype} and {vals.dtype}")
    dev = keys.device
    if vals.device != dev or (valid is not None and valid.device != dev):
        raise ValueError("build_table: keys, values and validity must share "
                         "one device")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != keys.shape):
        raise ValueError("build_table: validity must be bool of the keys' "
                         "shape")
    if n > _INT32_MAX:
        raise ValueError(f"build_table: {n} rows is more than int32 indexes")
    tk = torch.full((table_size,), empty_key, dtype=torch.int32, device=dev)
    tv = torch.zeros(table_size, dtype=torch.int32, device=dev)
    if n == 0:
        return tk, tv
    keys, vals = keys.contiguous(), vals.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if n >= table_size:
        rc = _build_rounds(keys, vals, valid, n, table_size, empty_key, tk,
                           tv, stream)
    else:
        valid = None if valid is None else valid.contiguous()
        nbytes = build.function(_LIB, "hash_table_build_scratch_bytes",
                                [ctypes.c_longlong], ctypes.c_longlong,
                                device=dev)(n)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        fn = build.function(_LIB, "hash_table_build", _BUILD_ARGTYPES,
                            device=dev)
        rc = fn(keys.data_ptr(), vals.data_ptr(),
                None if valid is None else valid.data_ptr(), n, table_size,
                empty_key, tk.data_ptr(), tv.data_ptr(), scratch.data_ptr(),
                nbytes, stream)
    build.check(_LIB, rc, "build_table")
    ops.count_launch("build_table")
    return tk, tv


def _build_rounds(keys, vals, valid, n, table_size, empty_key, tk, tv,
                  stream):
    """The round kernels, for ``n >= table_size`` rows: the host reads the
    unplaced count back every 8 rounds and stops at 0 or after
    ``table_size`` rounds, as the reference does."""
    dev = keys.device
    placed = (torch.zeros(n, dtype=torch.uint8, device=dev) if valid is None
              else (~valid).to(torch.uint8))
    winner = torch.full((table_size,), _INT32_MAX, dtype=torch.int32,
                        device=dev)
    unplaced = torch.zeros(1, dtype=torch.int32, device=dev)
    fn = build.function(_LIB, "hash_table_build_rounds", _ROUNDS_ARGTYPES,
                        device=dev)
    return fn(keys.data_ptr(), vals.data_ptr(), placed.data_ptr(), n,
              table_size, empty_key, tk.data_ptr(), tv.data_ptr(),
              winner.data_ptr(), unplaced.data_ptr(), stream)


# ---------------------------------------------------------------------------
# probe
# ---------------------------------------------------------------------------

def hash_probe_plain(table_keys: torch.Tensor, table_vals: torch.Tensor,
                     probe_keys: torch.Tensor, empty_key: int = -1,
                     max_probes: int = MAX_PROBES_DEFAULT):
    """Plain version of ``hash_probe``: the reference's ``probe_loop``,
    all keys stepping together, stopping once every key is done."""
    t = table_keys.shape[0]
    _check_table_size(t)
    keys = probe_keys.to(torch.int32)
    home = hash_home(keys, t)
    found = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    val = torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    done = torch.zeros_like(found)
    for i in range(min(max_probes, t)):
        idx = (home + i) & (t - 1)
        slot_keys = table_keys.index_select(0, idx)
        hit = (slot_keys == keys) & ~done
        miss = (slot_keys == empty_key) & ~done
        found |= hit
        val = torch.where(hit, table_vals.index_select(0, idx), val)
        done |= hit | miss
        if bool(done.all()):
            break
    return found, val


@ops.reports("hash_probe", hash_probe_work)
def hash_probe(table_keys: torch.Tensor, table_vals: torch.Tensor,
               probe_keys: torch.Tensor, empty_key: int = -1,
               max_probes: int = MAX_PROBES_DEFAULT):
    """Single-match probe -> ``(found bool[N], vals int32[N])``, ``vals`` 0
    where not found; at most ``min(max_probes, T)`` slots per key. A probe
    key equal to ``empty_key`` reports a hit on an empty slot, as in the
    reference; callers mask it.

    On the card the join calls this once per probe batch, so the wrapper
    does per call only what the call needs: its checks read the tensors'
    attributes without building device objects, both outputs are views of
    one allocation, and the stream is PyTorch's raw current stream."""
    ops.mark_kernel("probe")
    if not probe_keys.is_cuda:
        return hash_probe_plain(table_keys, table_vals, probe_keys,
                                empty_key, max_probes)
    t = table_keys.shape[0]
    n = probe_keys.shape[0]
    index = probe_keys.get_device()
    if (table_keys.dtype != torch.int32 or table_vals.dtype != torch.int32
            or probe_keys.dtype != torch.int32 or table_keys.dim() != 1
            or probe_keys.dim() != 1 or table_vals.shape != table_keys.shape
            or table_keys.get_device() != index
            or table_vals.get_device() != index):
        # raises, naming the argument at fault
        _check_probe_args("hash_probe", table_keys, table_vals, probe_keys)
    if t & (t - 1) or not 0 < t <= 1 << 30:
        _check_table_size(t)   # raises
    out = torch.empty(5 * n, dtype=torch.uint8, device=probe_keys.device)
    vals = out[:4 * n].view(torch.int32)
    found = out[4 * n:].view(torch.bool)
    if n == 0:
        return found, vals
    if not (table_keys.is_contiguous() and table_vals.is_contiguous()
            and probe_keys.is_contiguous()):
        table_keys, table_vals, probe_keys = (
            table_keys.contiguous(), table_vals.contiguous(),
            probe_keys.contiguous())
    fn = build.function(_LIB, "hash_table_probe", _PROBE_ARGTYPES,
                        device=probe_keys.device)
    rc = fn(table_keys.data_ptr(), table_vals.data_ptr(), t,
            min(max_probes, t), empty_key, probe_keys.data_ptr(), n,
            found.data_ptr(), vals.data_ptr(),
            torch._C._cuda_getCurrentRawStream(index))
    if rc:
        build.check(_LIB, rc, "hash_probe")
    ops.count_launch("hash_probe")
    return found, vals


def _check_probe_args(name, table_keys, table_vals, probe_keys):
    t = table_keys.shape[0]
    _check_table_size(t)
    dev = probe_keys.device
    for arg, a in (("table_keys", table_keys), ("table_vals", table_vals),
                   ("probe_keys", probe_keys)):
        if a.dtype != torch.int32 or a.dim() != 1 or a.device != dev:
            raise TypeError(f"{name}: {arg} must be int32[...] on {dev}, "
                            f"got {a.dtype}{tuple(a.shape)} on {a.device}")
    if table_vals.shape != table_keys.shape:
        raise ValueError(f"{name}: table keys and values differ in size")


# ---------------------------------------------------------------------------
# expansion probe
# ---------------------------------------------------------------------------

def hash_probe_multi_plain(table_keys: torch.Tensor, table_vals: torch.Tensor,
                           probe_keys: torch.Tensor, max_matches: int,
                           empty_key: int = -1,
                           max_probes: int = MAX_PROBES_DEFAULT):
    """Plain version of ``hash_probe_multi``: the reference's
    ``probe_loop_multi``, all keys stepping together through the run with
    a cursor, stopping once every key is done."""
    t = table_keys.shape[0]
    _check_table_size(t)
    keys = probe_keys.to(torch.int32)
    n = keys.shape[0]
    dev = keys.device
    home = hash_home(keys, t)
    count = torch.zeros(n, dtype=torch.int32, device=dev)
    slots = torch.zeros((n, max_matches), dtype=torch.int32, device=dev)
    lane = torch.arange(max_matches, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    for i in range(min(max_probes, t)):
        idx = (home + i) & (t - 1)
        slot_keys = table_keys.index_select(0, idx)
        hit = (slot_keys == keys) & ~done & (count < max_matches)
        sel = hit[:, None] & (lane[None, :] == count[:, None])
        slots = torch.where(sel, table_vals.index_select(0, idx)[:, None],
                            slots)
        count = count + hit.to(torch.int32)
        done |= ((slot_keys == empty_key) & ~done) | (count >= max_matches)
        if bool(done.all()):
            break
    return count, slots


@ops.reports("hash_probe_multi", hash_probe_multi_work)
def hash_probe_multi(table_keys: torch.Tensor, table_vals: torch.Tensor,
                     probe_keys: torch.Tensor, max_matches: int,
                     empty_key: int = -1,
                     max_probes: int = MAX_PROBES_DEFAULT):
    """Expansion probe -> ``(count int32[N], slots int32[N, max_matches])``:
    ``slots[i, :count[i]]`` are the values of every slot whose key equals
    ``probe_keys[i]``, in run order (build-row order), at most
    ``max_matches`` of them; ``slots[i, count[i]:]`` hold 0 (the kernel
    writes them), so a gather through every slot stays in bounds. A probe
    key equal to ``empty_key`` reports one bogus match, as in the
    reference; callers mask it.

    On the card, as ``hash_probe``'s: checks that read the tensors'
    attributes, one allocation (``slots`` first, so that its rows are
    aligned for the kernel's whole-row stores, then ``count``), and
    PyTorch's raw current stream."""
    ops.mark_kernel("probe")
    if not probe_keys.is_cuda:
        return hash_probe_multi_plain(table_keys, table_vals, probe_keys,
                                      max_matches, empty_key, max_probes)
    t = table_keys.shape[0]
    n = probe_keys.shape[0]
    index = probe_keys.get_device()
    if (table_keys.dtype != torch.int32 or table_vals.dtype != torch.int32
            or probe_keys.dtype != torch.int32 or table_keys.dim() != 1
            or probe_keys.dim() != 1 or table_vals.shape != table_keys.shape
            or table_keys.get_device() != index
            or table_vals.get_device() != index):
        # raises, naming the argument at fault
        _check_probe_args("hash_probe_multi", table_keys, table_vals,
                          probe_keys)
    if t & (t - 1) or not 0 < t <= 1 << 30:
        _check_table_size(t)   # raises
    if not 1 <= max_matches < 2 ** 16:
        raise ValueError(f"hash_probe_multi: max_matches {max_matches} out "
                         "of range")
    out = torch.empty(n * (max_matches + 1), dtype=torch.int32,
                      device=probe_keys.device)
    slots = out[:n * max_matches].view(n, max_matches)
    count = out[n * max_matches:]
    if n == 0:
        return count, slots
    if not (table_keys.is_contiguous() and table_vals.is_contiguous()
            and probe_keys.is_contiguous()):
        table_keys, table_vals, probe_keys = (
            table_keys.contiguous(), table_vals.contiguous(),
            probe_keys.contiguous())
    fn = build.function(_LIB, "hash_table_probe_multi", _PROBE_MULTI_ARGTYPES,
                        device=probe_keys.device)
    rc = fn(table_keys.data_ptr(), table_vals.data_ptr(), t,
            min(max_probes, t), empty_key, probe_keys.data_ptr(), n,
            max_matches, count.data_ptr(), slots.data_ptr(),
            torch._C._cuda_getCurrentRawStream(index))
    if rc:
        build.check(_LIB, rc, "hash_probe_multi")
    ops.count_launch("hash_probe_multi")
    return count, slots


# ---------------------------------------------------------------------------
# probe bound
# ---------------------------------------------------------------------------

def longest_run(table_keys: torch.Tensor, empty_key: int = -1
                ) -> torch.Tensor:
    """The longest circular run of occupied slots (0-d, on the table's
    device, not synchronised). The free slots cut the table into runs:
    slot i lies in run ``cumsum(free)[i]``, and one ``index_add_`` counts
    each run's occupied slots. The run before the first free slot
    continues the one after the last free slot. (``torch.cummax`` of the
    last free slot would do it in one pass, but on the card it is a slow
    scan with indices: tens of ms on 2^24 slots.)"""
    t = table_keys.shape[0]
    free = table_keys == empty_key
    run = torch.cumsum(free, 0)
    counts = torch.zeros(t + 1, dtype=torch.int64, device=table_keys.device)
    counts.index_add_(0, run, (~free).to(torch.int64))
    wrapped = counts[0] + counts.gather(0, run[-1:])[0]
    return torch.clamp(torch.maximum(counts.max(), wrapped), max=t)


def probe_bound_of_run(longest: int, table_size: int) -> int:
    """``max_probes`` for a table whose longest occupied run is
    ``longest``: run + 1 (a probe stops at the first empty slot), rounded
    up to a power of two, capped at the table size."""
    need = max(int(longest) + 1, 2)
    return min(1 << (need - 1).bit_length(), table_size)


def probe_bound(table_keys: torch.Tensor, empty_key: int = -1) -> int:
    """The reference's ``operators._probe_bound`` of one table."""
    return probe_bound_of_run(int(longest_run(table_keys, empty_key)),
                              table_keys.shape[0])
