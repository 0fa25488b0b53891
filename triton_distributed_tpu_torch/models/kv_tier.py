"""Local KV tier: a host-RAM (and optional disk) page store.

Counterpart of ``triton_distributed_tpu/models/kv_tier.py``, host-only
and near verbatim. Two users share one store:

- the radix prefix cache: an evicted full page spills into it keyed by
  its token-chain digest (``PREFIX_KIND``) and admission faults it back
  instead of re-prefilling it;
- sharded long-context slots: the cold pages of a live over-budget
  request (``LONGCTX_KIND``, keyed ``"<uid>:<page-index>"``), deleted
  with the request.

Entries are stored as their wire bytes (version header + CRC32 over a
JSON body), in a byte-bounded RAM LRU and, with ``dir=``, write-through
to one file per entry (atomic write-then-rename). A checksum mismatch,
a truncated file, a wrong magic or a key mismatch never yields wrong
bits: :meth:`PageStore.get` drops the entry and returns None, and the
caller re-prefills. A payload encodes to the same bytes as the JAX
package's ``_encode`` of the same arrays, so the two packages can read
each other's stores.

Arrays ride the base64 codec of the JAX ``slot_state`` wire format
(``_arr_to_wire``/``_arr_from_wire``, copied here: the port has no
``slot_state`` yet). It encodes torch tensors and decodes to CPU torch
tensors; bfloat16 travels as its raw 2-byte words, since numpy has no
bfloat16 of its own.

Not ported (ROADMAP queue 1): the KV fabric (``FabricClient`` and its
peers) and the ``tier.put``/``tier.get`` fault seams. ``SNAP_KIND`` is
defined for the shared format; nothing in the port writes it yet.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import threading
import zlib
from collections import OrderedDict

import numpy as np
import torch

from triton_distributed_tpu_torch.obs import events as obs_events
from triton_distributed_tpu_torch.obs import metrics as obs_metrics

TIER_VERSION = 1
_MAGIC = b"TDT1"

PREFIX_KIND = "prefix"
SNAP_KIND = "snap"
# Cold pages of a LIVE sharded long-context slot: per-page
# ``prefix_payload`` dicts keyed "<uid>:<page-index>"; they belong to one
# running request and are deleted at its teardown, so the disk prune
# (which only bounds PREFIX/SNAP) never reaps a page a decode still needs.
LONGCTX_KIND = "longctx"


class TierIntegrityError(RuntimeError):
    """An entry's bytes failed the header/checksum validation — the
    payload cannot be trusted and must be dropped, never decoded into
    KV bits."""


def chain_digest(tokens) -> str:
    """Stable digest of an exact token chain — the ``prefix`` entry key:
    a spilled radix page is keyed by the FULL chain from the root through
    its own chunk, so fault-back can probe page by page."""
    return hashlib.sha1(
        np.asarray([int(t) for t in tokens], np.int64).tobytes()
    ).hexdigest()


# -- array wire codec ---------------------------------------------------------

# numpy's name of each dtype the tier carries, and back.
_TORCH_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "int8": torch.int8, "int32": torch.int32,
    "int64": torch.int64,
}


def _arr_to_wire(t: torch.Tensor | None) -> dict | None:
    """``{"dtype", "shape", "b64"}`` of a tensor, in C order, its dtype
    by numpy's name (the JAX codec's format)."""
    if t is None:
        return None
    t = t.detach().cpu().contiguous()
    raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    return {"dtype": str(t.dtype).removeprefix("torch."),
            "shape": list(t.shape),
            "b64": base64.b64encode(raw.tobytes()).decode("ascii")}


def _arr_from_wire(d: dict | None) -> torch.Tensor | None:
    """The CPU tensor of one wire dict; ValueError on a malformed one."""
    if d is None:
        return None
    try:
        dtype = _TORCH_DTYPES[d["dtype"]]
        raw = base64.b64decode(d["b64"])
        shape = [int(n) for n in d["shape"]]
        if dtype == torch.bfloat16:
            flat = torch.from_numpy(np.frombuffer(raw, np.int16).copy())
            flat = flat.view(torch.bfloat16)
        else:
            flat = torch.from_numpy(
                np.frombuffer(raw, np.dtype(d["dtype"])).copy())
        return flat.reshape(shape)
    except (KeyError, TypeError, ValueError, RuntimeError) as e:
        raise ValueError(
            f"malformed tier array: {type(e).__name__}: {e}") from e


# -- prefix-page payload codec --------------------------------------------
#
# One page's content as a line-JSON-safe dict. ``chain`` is the page's
# full token chain (the page holds chain[-page_size:]), kept IN the
# payload so fault-back can verify the digest did not collide and the
# audit can cross-check key and chain.


def prefix_payload(chain, page_size: int, kv_dtype: str | None,
                   k_page, v_page, k_scale=None, v_scale=None) -> dict:
    return {
        "chain": [int(t) for t in chain],
        "page_size": int(page_size),
        "kv_dtype": kv_dtype,
        "k": _arr_to_wire(k_page),
        "v": _arr_to_wire(v_page),
        "ks": _arr_to_wire(k_scale),
        "vs": _arr_to_wire(v_scale),
    }


def decode_prefix_payload(payload: dict):
    """``(chain, page_size, kv_dtype, k, v, ks, vs)`` from a ``prefix``
    payload, arrays as CPU tensors; raises :class:`TierIntegrityError`
    on any malformed field (the caller drops the entry and
    re-prefills)."""
    try:
        chain = [int(t) for t in payload["chain"]]
        page_size = int(payload["page_size"])
        kv_dtype = payload.get("kv_dtype")
        k = _arr_from_wire(payload["k"])
        v = _arr_from_wire(payload["v"])
        ks = _arr_from_wire(payload.get("ks"))
        vs = _arr_from_wire(payload.get("vs"))
    except (KeyError, TypeError, ValueError) as e:
        raise TierIntegrityError(
            f"malformed prefix payload: {type(e).__name__}: {e}"
        ) from e
    if k is None or v is None:
        raise TierIntegrityError("prefix payload missing page arrays")
    return chain, page_size, kv_dtype, k, v, ks, vs


def payload_nbytes(payload: dict) -> int:
    """Approximate payload size (the base64 blobs dominate) — what the
    engine's ``tier_bytes`` counters accumulate per fault-back."""
    total = 0
    for v in payload.values():
        if isinstance(v, dict) and "b64" in v:
            total += len(v["b64"])
    return total


# -- entry wire format ----------------------------------------------------


def _encode(kind: str, key: str, payload: dict) -> bytes:
    body = json.dumps(payload, separators=(",", ":")).encode()
    head = json.dumps({
        "v": TIER_VERSION, "kind": kind, "key": key,
        "len": len(body), "crc": zlib.crc32(body),
    }, separators=(",", ":")).encode()
    return _MAGIC + head + b"\n" + body


def _decode(kind: str, key: str, blob: bytes) -> dict:
    """Validate + decode one entry blob; raises
    :class:`TierIntegrityError` on wrong magic, unparseable or
    mismatched header, truncation, or a CRC mismatch."""
    if not blob.startswith(_MAGIC):
        raise TierIntegrityError("bad magic (not a tier entry)")
    head_raw, sep, body = blob[len(_MAGIC):].partition(b"\n")
    if not sep:
        raise TierIntegrityError("truncated entry (no header terminator)")
    try:
        head = json.loads(head_raw)
    except ValueError as e:
        raise TierIntegrityError(f"unparseable header: {e}") from e
    if not isinstance(head, dict):
        raise TierIntegrityError("unparseable header: not an object")
    if head.get("v") != TIER_VERSION:
        raise TierIntegrityError(f"version mismatch: {head.get('v')!r}")
    if head.get("kind") != kind or head.get("key") != key:
        raise TierIntegrityError(
            f"entry is ({head.get('kind')!r}, {head.get('key')!r}), "
            f"expected ({kind!r}, {key!r})"
        )
    if len(body) != head.get("len"):
        raise TierIntegrityError(
            f"truncated body: {len(body)} != {head.get('len')}"
        )
    if zlib.crc32(body) != head.get("crc"):
        raise TierIntegrityError("checksum mismatch")
    try:
        return json.loads(body)
    except ValueError as e:  # crc passed but json broke: still contained
        raise TierIntegrityError(f"unparseable body: {e}") from e


class PageStore:
    """Capacity-bounded host-RAM tier with an optional write-through
    disk tier (see the module docstring). Thread-safe."""

    def __init__(self, capacity_bytes: int = 64 << 20,
                 dir: str | None = None,  # noqa: A002 — the public knob name
                 disk_capacity_bytes: int | None = None,
                 fsync: bool = True):
        self.capacity_bytes = int(capacity_bytes)
        self.dir = dir
        # fsync=False trades power-loss durability for write latency: the
        # atomic rename still makes every entry visible whole to a
        # restarted process, and an OS crash can only tear an entry the
        # CRC then drops.
        self.fsync = bool(fsync)
        self.disk_capacity_bytes = (
            None if disk_capacity_bytes is None else int(disk_capacity_bytes)
        )
        if dir:
            os.makedirs(dir, exist_ok=True)
        self._ram: "OrderedDict[tuple[str, str], bytes]" = OrderedDict()
        self._ram_bytes = 0
        self._lock = threading.RLock()
        # Memos of resident_chains/digest, keyed by a mutation counter
        # that every RAM-membership change bumps.
        self._mut = 0
        self._chain_memo: tuple[int, list[list[int]]] | None = None
        self._digest_memo: tuple[int, dict] | None = None
        # Monotone per-kind non-emptiness flags (see may_contain): one
        # listdir at construction counts entries a prior process left on
        # disk; every successful put flips the flag for good.
        self._kind_seen: dict[str, bool] = {
            PREFIX_KIND: False, SNAP_KIND: False,
        }
        if dir:
            for kd in (PREFIX_KIND, SNAP_KIND):
                try:
                    self._kind_seen[kd] = any(
                        n.endswith(".tier")
                        for n in os.listdir(os.path.join(dir, kd))
                    )
                except OSError:
                    pass
        self.stats = {
            "puts": 0,
            "put_bytes": 0,
            "hits": 0,
            "disk_hits": 0,
            "misses": 0,
            "evictions": 0,       # RAM LRU evictions (disk copy survives)
            "disk_evictions": 0,  # disk-bound prunes — permanent deletions
            "drops": 0,       # integrity failures — entry removed
            "refused": 0,     # puts refused (oversized or unencodable)
            "errors": 0,      # I/O errors (degraded)
        }
        self._m_drops = obs_metrics.counter(
            "tdt_tier_drops_total",
            "Tier entries dropped on integrity failure (checksum / "
            "truncation / header mismatch) — degraded to re-prefill "
            "or replay, never wrong bits.",
        )
        self._m_evictions = obs_metrics.counter(
            "tdt_tier_store_evictions_total",
            "Entries LRU-evicted from the tier's RAM capacity (the "
            "disk copy, when a disk tier is attached, survives).",
        )
        self._m_disk_evictions = obs_metrics.counter(
            "tdt_tier_disk_evictions_total",
            "Entries pruned from the disk tier's byte bound — "
            "PERMANENT deletions, unlike RAM evictions.",
        )
        self._g_bytes = obs_metrics.gauge(
            "tdt_tier_ram_bytes", "Bytes held by the tier's RAM LRU.",
        )

    # -- paths -------------------------------------------------------------

    def _path(self, kind: str, key: str) -> str:
        # Filenames are key digests (keys may hold '/'); the header's
        # embedded key is what guards against digest collisions.
        name = hashlib.sha1(key.encode()).hexdigest() + ".tier"
        return os.path.join(self.dir, kind, name)

    # -- write -------------------------------------------------------------

    def put(self, kind: str, key: str, payload: dict) -> bool:
        """Store one entry; returns False when refused (unencodable, or
        larger than the whole RAM capacity) — the caller treats a refused
        spill like the pre-tier drop-to-nothing."""
        try:
            blob = _encode(kind, key, payload)
        except (TypeError, ValueError):
            with self._lock:
                self.stats["refused"] += 1
            return False
        if len(blob) > self.capacity_bytes:
            with self._lock:
                self.stats["refused"] += 1
            return False
        with self._lock:
            self._ram_insert(kind, key, blob)
            self.stats["puts"] += 1
            self.stats["put_bytes"] += len(blob)
            self._kind_seen[kind] = True
        if self.dir:
            self._disk_write(kind, key, blob)
        return True

    def _ram_insert(self, kind: str, key: str, blob: bytes) -> None:
        """Insert into the RAM LRU and evict down to capacity. Caller
        holds ``_lock``. An entry already held under the key is replaced,
        not double-counted."""
        old = self._ram.pop((kind, key), None)
        if old is not None:
            self._ram_bytes -= len(old)
        self._ram[(kind, key)] = blob
        self._ram_bytes += len(blob)
        self._mut += 1
        while self._ram_bytes > self.capacity_bytes and len(self._ram) > 1:
            _, evicted = self._ram.popitem(last=False)
            self._ram_bytes -= len(evicted)
            self._mut += 1
            self.stats["evictions"] += 1
            self._m_evictions.inc()
        self._g_bytes.set(self._ram_bytes)

    def _disk_write(self, kind: str, key: str, blob: bytes) -> None:
        path = self._path(kind, key)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())
            os.replace(tmp, path)  # atomic: readers see old or new, never half
        except OSError:
            with self._lock:
                self.stats["errors"] += 1
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return
        if self.disk_capacity_bytes is not None:
            self._disk_prune()

    def _disk_prune(self) -> None:
        """LRU-by-mtime prune of the disk tier to its byte bound."""
        entries = []
        total = 0
        for kind in (PREFIX_KIND, SNAP_KIND):
            d = os.path.join(self.dir, kind)
            if not os.path.isdir(d):
                continue
            for name in os.listdir(d):
                if not name.endswith(".tier"):
                    continue
                p = os.path.join(d, name)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                entries.append((st.st_mtime, st.st_size, p))
                total += st.st_size
        entries.sort()
        for _, size, p in entries:
            if total <= self.disk_capacity_bytes:
                break
            try:
                os.unlink(p)
                total -= size
                with self._lock:
                    self.stats["disk_evictions"] += 1
                self._m_disk_evictions.inc()
            except OSError:
                pass

    # -- read --------------------------------------------------------------

    def _read_file(self, kind: str, key: str) -> bytes | None:
        with open(self._path(kind, key), "rb") as f:
            return f.read()

    def get(self, kind: str, key: str) -> dict | None:
        """Fetch + integrity-check one entry. None on a miss, on a read
        error, or on ANY integrity failure (the entry is then dropped
        everywhere and counted) — wrong bits never come out of here."""
        src = "ram"
        with self._lock:
            blob = self._ram.get((kind, key))
            if blob is not None:
                self._ram.move_to_end((kind, key))
        if blob is None and self.dir:
            src = "disk"
            try:
                blob = self._read_file(kind, key)
            except FileNotFoundError:
                blob = None
            except OSError:
                with self._lock:
                    self.stats["errors"] += 1
                return None
        if blob is None:
            with self._lock:
                self.stats["misses"] += 1
            return None
        try:
            payload = _decode(kind, key, blob)
        except TierIntegrityError as e:
            self._drop(kind, key, str(e))
            return None
        with self._lock:
            self.stats["hits"] += 1
            if src == "disk":
                self.stats["disk_hits"] += 1
                # Promote: the RAM front absorbs the next lookup.
                self._ram_insert(kind, key, blob)
        return payload

    def peek(self, kind: str, key: str) -> dict | None:
        """Decode an entry WITHOUT stats, LRU movement or drop-on-failure
        — the audit's read path. None when absent or unreadable."""
        with self._lock:
            blob = self._ram.get((kind, key))
        if blob is None and self.dir:
            try:
                blob = self._read_file(kind, key)
            except OSError:
                return None
        if blob is None:
            return None
        try:
            return _decode(kind, key, blob)
        except TierIntegrityError:
            return None

    def contains(self, kind: str, key: str) -> bool:
        """Membership WITHOUT decode, stats, or LRU movement. A True is
        advisory (the entry may still fail its checksum); a False is
        authoritative for this instant."""
        with self._lock:
            if (kind, key) in self._ram:
                return True
        if self.dir:
            return os.path.exists(self._path(kind, key))
        return False

    def _drop(self, kind: str, key: str, reason: str) -> None:
        """Remove a failed entry from BOTH tiers: the bits are suspect
        wherever they live."""
        with self._lock:
            blob = self._ram.pop((kind, key), None)
            if blob is not None:
                self._ram_bytes -= len(blob)
                self._mut += 1
                self._g_bytes.set(self._ram_bytes)
            self.stats["drops"] += 1
        self._m_drops.inc()
        if self.dir:
            try:
                os.unlink(self._path(kind, key))
            except OSError:
                pass
        obs_events.emit(
            "tier_drop", tier_kind=kind, key=str(key)[:64],
            reason=str(reason)[:160],
        )

    # -- management --------------------------------------------------------

    def delete(self, kind: str, key: str) -> None:
        with self._lock:
            blob = self._ram.pop((kind, key), None)
            if blob is not None:
                self._ram_bytes -= len(blob)
                self._mut += 1
                self._g_bytes.set(self._ram_bytes)
        if self.dir:
            try:
                os.unlink(self._path(kind, key))
            except OSError:
                pass

    def clear(self, kind: str | None = None) -> int:
        """Drop every entry (of ``kind``, or all) from both tiers.
        Returns the entries removed."""
        removed = 0
        with self._lock:
            for k in [k for k in self._ram if kind is None or k[0] == kind]:
                self._ram_bytes -= len(self._ram.pop(k))
                removed += 1
            if removed:
                self._mut += 1
            self._g_bytes.set(self._ram_bytes)
        if self.dir:
            for kd in (PREFIX_KIND, SNAP_KIND):
                if kind is not None and kd != kind:
                    continue
                d = os.path.join(self.dir, kd)
                if not os.path.isdir(d):
                    continue
                for name in os.listdir(d):
                    if name.endswith(".tier"):
                        try:
                            os.unlink(os.path.join(d, name))
                            removed += 1
                        except OSError:
                            pass
        return removed

    def may_contain(self, kind: str) -> bool:
        """Cheap monotone emptiness guard: False only while the store has
        NEVER held an entry of ``kind`` (neither this process nor, with a
        disk tier, a prior one over the same dir). Deletes never reset
        it: it may over-probe, never under-probe."""
        return self._kind_seen.get(kind, True)

    def keys(self, kind: str) -> list[str]:
        """Every live key of ``kind`` (RAM ∪ disk). Disk filenames are
        key digests, so the key is read from each entry's header;
        unreadable files are skipped (a later ``get`` would drop them)."""
        out = {k for (kd, k) in self._ram if kd == kind}
        if self.dir:
            d = os.path.join(self.dir, kind)
            if os.path.isdir(d):
                for name in os.listdir(d):
                    if not name.endswith(".tier"):
                        continue
                    try:
                        with open(os.path.join(d, name), "rb") as f:
                            blob = f.read()
                        head_raw, sep, _ = blob[len(_MAGIC):].partition(b"\n")
                        if not blob.startswith(_MAGIC) or not sep:
                            continue
                        key = json.loads(head_raw).get("key")
                        if isinstance(key, str):
                            out.add(key)
                    except (OSError, ValueError):
                        continue
        return sorted(out)

    def resident_chains(self) -> list[list[int]]:
        """Token chains of the RAM-resident ``prefix`` entries: what the
        tree-speculation drafter scans for continuations whose pages left
        the radix tree. Only each body's chain is parsed; memoized until
        the RAM membership changes; no stats or LRU movement."""
        with self._lock:
            memo = self._chain_memo
            if memo is not None and memo[0] == self._mut:
                return memo[1]
            mut = self._mut
            blobs = [
                blob for (kd, _), blob in self._ram.items()
                if kd == PREFIX_KIND
            ]
        chains: list[list[int]] = []
        for blob in blobs:
            try:
                _, sep, body = blob[len(_MAGIC):].partition(b"\n")
                if not blob.startswith(_MAGIC) or not sep:
                    continue
                chain = json.loads(body).get("chain")
            except ValueError:
                continue  # a later get() integrity-drops it
            if isinstance(chain, list) and chain:
                chains.append([int(t) for t in chain])
        with self._lock:
            if self._mut == mut:
                self._chain_memo = (mut, chains)
        return chains

    def digest(self) -> dict:
        """Compact content summary ``{"hash", "counts", "chains"}``:
        the sorted 16-hex truncations of the RAM-resident ``prefix``
        keys, the per-kind RAM entry counts, and a digest of the chain
        set. Memoized on the mutation counter."""
        with self._lock:
            memo = self._digest_memo
            if memo is not None and memo[0] == self._mut:
                return memo[1]
            counts: dict[str, int] = {}
            chains: list[str] = []
            for (kd, key) in self._ram:
                counts[kd] = counts.get(kd, 0) + 1
                if kd == PREFIX_KIND:
                    chains.append(key[:16])
            chains.sort()
            out = {
                "hash": hashlib.sha1(
                    "\n".join(chains).encode()
                ).hexdigest()[:16],
                "counts": counts,
                "chains": chains,
            }
            self._digest_memo = (self._mut, out)
            return out

    @property
    def ram_bytes(self) -> int:
        with self._lock:
            return self._ram_bytes

    def snapshot(self) -> dict:
        """Counters + occupancy for ``last_stats["tier"]``."""
        with self._lock:
            out = dict(self.stats)
            out["ram_bytes"] = self._ram_bytes
            out["ram_entries"] = len(self._ram)
        out["capacity_bytes"] = self.capacity_bytes
        out["dir"] = self.dir
        return out

    def audit(self) -> list[str]:
        """Structural invariants over the RAM tier (disk entries are
        verified on every ``get``): every blob decodes under its own
        (kind, key), prefix entries' chain matches their digest key, and
        the byte ledger matches the blobs held. Returns violation
        strings (empty == clean)."""
        problems: list[str] = []
        with self._lock:
            items = list(self._ram.items())
            ram_bytes = self._ram_bytes
        total = 0
        for (kind, key), blob in items:
            total += len(blob)
            try:
                payload = _decode(kind, key, blob)
            except TierIntegrityError as e:
                problems.append(f"entry ({kind}, {key[:16]}…): {e}")
                continue
            if kind == PREFIX_KIND:
                chain = payload.get("chain")
                if not isinstance(chain, list) or chain_digest(chain) != key:
                    problems.append(
                        f"prefix entry {key[:16]}…: digest key does not "
                        "match its payload token chain"
                    )
        if total != ram_bytes:
            problems.append(
                f"RAM byte ledger {ram_bytes} != {total} held"
            )
        return problems
