"""Stream brokers for Cluster Serving (counterpart of
``analytics_zoo_tpu/serving/broker.py``, the same protocol and files).

Data model mirrors the reference's Redis usage (serving/ClusterServing.scala:
103-139, serving/utils/RedisUtils.scala): an append-only *stream* of
(uri, payload) records, and per-uri *result hashes*.  Three transports:

- :class:`InMemoryBroker` — threading-based, for embedded serving + tests.
- :class:`FileBroker` — a spool directory; atomic-rename appends make it
  safe across processes on one host with no external
  service.
- :class:`RedisBroker` — the reference transport, gated on ``import redis``.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid


class Broker:
    """Minimal stream + hash API (subset of Redis streams).

    The ``claim``/``extend``/``release`` trio is the fleet's
    exactly-once work-claiming protocol (serving/fleet.py): a replica
    CLAIMS records under a lease instead of reading by cursor, so N
    replicas against one stream never double-serve; a replica that dies
    mid-batch simply stops extending, and after ``lease_ms`` its
    claimed-but-unserved records become claimable again (the lease-expiry
    takeover a survivor performs).  ``release(done=True)`` is the
    claimed-record ack; ``done=False`` requeues immediately (clean
    shutdown path — no other replica waits out the lease)."""

    def xadd(self, stream: str, fields: dict) -> str:
        raise NotImplementedError

    def xread(self, stream: str, count: int, last_id: str = "0",
              block_ms: int = 0) -> list:
        """Return up to ``count`` records ``(id, fields)`` with id >
        last_id; optionally block up to ``block_ms``."""
        raise NotImplementedError

    def claim(self, stream: str, owner: str, count: int, lease_ms: int,
              block_ms: int = 0) -> list:
        """Atomically claim up to ``count`` unclaimed (or lease-expired)
        records for ``owner``; returns ``[(id, fields)]``.  Claimed
        records stay in the stream but are invisible to other claimers
        until the lease expires or they are released.  ``block_ms`` > 0
        waits for claimable records (new arrivals OR an expiring
        lease)."""
        raise NotImplementedError

    def extend(self, stream: str, owner: str, ids, lease_ms: int) -> None:
        """Renew ``owner``'s lease on ``ids`` (the mid-batch keepalive —
        a first predict may pay a multi-second capture).  Ids no
        longer owned (expired + taken over, or already released) are
        silently skipped."""
        raise NotImplementedError

    def release(self, stream: str, owner: str, ids,
                done: bool = False) -> None:
        """End ``owner``'s claim on ``ids``.  ``done=True`` acks: the
        records leave the stream (served, or judged unservable).
        ``done=False`` requeues them for immediate re-claim.  Ids not
        currently owned by ``owner`` are silently skipped — a lease that
        expired mid-flight may already belong to a survivor."""
        raise NotImplementedError

    def unclaimed(self, stream: str) -> int:
        """Backlog a new claimer could serve right now: records with no
        live lease.  The fleet autoscaler reads THIS, not ``xlen`` —
        in-flight claimed work is capacity already being used, not
        demand.  Brokers without claim support report ``xlen``."""
        return self.xlen(stream)

    def pop_takeovers(self, owner: str) -> int:
        """Number of lease-EXPIRY takeovers ``owner``'s claims performed
        since the last call (claims of records a dead replica left
        behind).  Read-and-reset; brokers without claim support return
        0."""
        return 0

    def lease_held(self, stream: str) -> bool:
        """True iff ``stream`` is non-empty and every record in it is
        under a LIVE lease — the membership-liveness predicate
        (elastic/membership.py): a worker's single-record member stream
        reports ``True`` while its keepalive extends the claim, and
        flips to ``False`` the instant the lease expires (dead) or the
        record is acked away (clean leave).  Derived from the claim
        protocol, so it holds on all brokers without new state."""
        return self.xlen(stream) > 0 and self.unclaimed(stream) == 0

    def xlen(self, stream: str) -> int:
        raise NotImplementedError

    def xtrim(self, stream: str, maxlen: int) -> None:
        """Drop oldest records beyond ``maxlen`` (backpressure cut,
        ClusterServing.scala:128-134)."""
        raise NotImplementedError

    def ack(self, stream: str, upto_id: str) -> None:
        """Delete consumed records with id <= upto_id (the server acks each
        micro-batch so streams do not grow without bound)."""
        raise NotImplementedError

    def hset(self, key: str, mapping: dict) -> None:
        raise NotImplementedError

    def hset_many(self, items: list) -> None:
        """Write many ``(key, mapping)`` hashes in ONE broker round-trip
        where the transport can (redis pipeline, one lock acquisition);
        this base fallback loops :meth:`hset` so brokers that only
        expose hset stay compatible.  The server writes each
        micro-batch's results through this — never per-record hset."""
        for key, mapping in items:
            self.hset(key, mapping)

    def hgetall(self, key: str) -> dict:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def keys(self, prefix: str) -> list:
        """Hash keys starting with ``prefix`` (the SCAN role needed by
        OutputQueue.dequeue)."""
        raise NotImplementedError

    def memory_ratio(self) -> float:
        """used_memory / maxmemory in [0,1]; brokers that cannot tell
        return 0.0 (no backpressure)."""
        return 0.0

    def close(self) -> None:
        pass


def _new_id() -> str:
    # time-ordered unique id (redis-style "<ms>-<seq>" flavour)
    return "%020d-%s" % (time.time_ns(), uuid.uuid4().hex[:8])


class InMemoryBroker(Broker):
    """All stream/hash/claim state lives under ONE Condition, so every
    blocking read (``xread``/``claim`` with ``block_ms`` > 0) is a
    ``Condition.wait`` woken by ``xadd``/``release`` — an idle fleet
    replica burns no CPU polling (and a claim waiter additionally wakes
    itself at the nearest lease expiry, the dead-replica takeover
    path)."""

    def __init__(self, max_records: int = 1_000_000):
        self._streams: dict[str, list] = {}  # guarded-by: _cv
        self._hashes: dict[str, dict] = {}  # guarded-by: _cv
        # stream -> {rid: (owner, monotonic deadline)} live leases
        self._claims: dict[str, dict] = {}  # guarded-by: _cv
        # owner -> lease-expiry takeovers performed (pop_takeovers)
        self._takeovers: dict[str, int] = {}  # guarded-by: _cv
        self._cv = threading.Condition()
        self._max_records = max_records

    def xadd(self, stream, fields):
        rid = _new_id()
        with self._cv:
            self._streams.setdefault(stream, []).append((rid, dict(fields)))
            self._cv.notify_all()
        return rid

    def xread(self, stream, count, last_id="0", block_ms=0):
        deadline = time.monotonic() + block_ms / 1000.0
        with self._cv:
            while True:
                recs = [r for r in self._streams.get(stream, [])
                        if r[0] > last_id][:count]
                if recs or block_ms <= 0:
                    return recs
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._cv.wait(remaining)

    def xlen(self, stream):
        with self._cv:
            return len(self._streams.get(stream, []))

    def xtrim(self, stream, maxlen):
        with self._cv:
            s = self._streams.get(stream, [])
            if len(s) > maxlen:
                dropped = s[:len(s) - maxlen]
                del s[:len(s) - maxlen]
                self._prune_claims_locked(stream, (r[0] for r in dropped))

    def ack(self, stream, upto_id):
        with self._cv:
            s = self._streams.get(stream, [])
            i = 0
            while i < len(s) and s[i][0] <= upto_id:
                i += 1
            acked = s[:i]
            del s[:i]
            self._prune_claims_locked(stream, (r[0] for r in acked))

    def _prune_claims_locked(self, stream, rids):
        """Drop leases for records that left the stream (ack/xtrim)."""
        claims = self._claims.get(stream)
        if claims:
            for rid in rids:
                claims.pop(rid, None)

    # -- exactly-once work claiming (fleet protocol) -------------------

    def claim(self, stream, owner, count, lease_ms, block_ms=0):
        deadline = time.monotonic() + block_ms / 1000.0
        with self._cv:
            while True:
                now = time.monotonic()
                claims = self._claims.setdefault(stream, {})
                out = []
                for rid, fields in self._streams.get(stream, []):
                    cur = claims.get(rid)
                    if cur is not None and cur[1] > now:
                        continue  # live lease held by someone
                    if cur is not None and cur[0] != owner:
                        # expired lease of a (presumed dead) replica
                        self._takeovers[owner] = \
                            self._takeovers.get(owner, 0) + 1
                    claims[rid] = (owner, now + lease_ms / 1000.0)
                    out.append((rid, dict(fields)))
                    if len(out) >= count:
                        break
                if out or block_ms <= 0:
                    return out
                remaining = deadline - now
                if remaining <= 0:
                    return []
                # also wake at the nearest lease expiry: a dead owner's
                # records become claimable without any notify
                expiries = [d for _, d in claims.values() if d > now]
                if expiries:
                    remaining = min(remaining, min(expiries) - now)
                self._cv.wait(max(remaining, 0.0))

    def extend(self, stream, owner, ids, lease_ms):
        with self._cv:
            now = time.monotonic()
            claims = self._claims.get(stream, {})
            for rid in ids:
                cur = claims.get(rid)
                if cur is not None and cur[0] == owner and cur[1] > now:
                    claims[rid] = (owner, now + lease_ms / 1000.0)

    def release(self, stream, owner, ids, done=False):
        ids = set(ids)
        with self._cv:
            claims = self._claims.get(stream, {})
            now = time.monotonic()
            owned = {rid for rid in ids
                     if (c := claims.get(rid)) is not None
                     and c[0] == owner and (done or c[1] > now)}
            # done=True also covers an expired-but-not-yet-taken-over
            # lease: the work WAS completed, the record must go
            for rid in owned:
                claims.pop(rid, None)
            if done and owned:
                s = self._streams.get(stream, [])
                s[:] = [r for r in s if r[0] not in owned]
            if owned and not done:
                self._cv.notify_all()  # requeued: wake claim waiters

    def unclaimed(self, stream):
        with self._cv:
            now = time.monotonic()
            claims = self._claims.get(stream, {})
            return sum(
                1 for rid, _ in self._streams.get(stream, [])
                if (c := claims.get(rid)) is None or c[1] <= now)

    def pop_takeovers(self, owner):
        with self._cv:
            return self._takeovers.pop(owner, 0)

    def hset(self, key, mapping):
        with self._cv:
            self._hashes.setdefault(key, {}).update(mapping)
            self._cv.notify_all()

    def hset_many(self, items):
        # one lock acquisition + one wakeup for the whole micro-batch
        with self._cv:
            for key, mapping in items:
                self._hashes.setdefault(key, {}).update(mapping)
            self._cv.notify_all()

    def hgetall(self, key):
        with self._cv:
            return dict(self._hashes.get(key, {}))

    def delete(self, key):
        with self._cv:
            self._hashes.pop(key, None)

    def keys(self, prefix):
        with self._cv:
            return [k for k in self._hashes if k.startswith(prefix)]

    def memory_ratio(self):
        n = sum(len(s) for s in self._streams.values())
        return min(1.0, n / self._max_records)


class FileBroker(Broker):
    """Spool-directory broker.

    Streams live under ``<root>/stream-<name>/<id>.json``; appends write a
    temp file then ``os.rename`` (atomic on POSIX), so multiple client
    processes and one server process interoperate without locks.  Result
    hashes are single json files under ``<root>/hash/``.
    """

    def __init__(self, root: str, max_bytes: int = 1 << 30):
        self.root = root
        self.max_bytes = int(max_bytes)
        # lease-expiry takeovers THIS instance performed, by owner
        # (one broker instance per replica process — no lock needed)
        self._takeovers: dict[str, int] = {}
        os.makedirs(os.path.join(root, "hash"), exist_ok=True)

    def _sdir(self, stream):
        d = os.path.join(self.root, "stream-" + stream)
        os.makedirs(d, exist_ok=True)
        return d

    def _hpath(self, key):
        return os.path.join(self.root, "hash", key.replace("/", "_") + ".json")

    def xadd(self, stream, fields):
        rid = _new_id()
        d = self._sdir(stream)
        tmp = os.path.join(d, ".tmp-" + rid)
        with open(tmp, "w") as f:
            json.dump(fields, f)
        os.rename(tmp, os.path.join(d, rid + ".json"))
        return rid

    def _ids(self, stream):
        d = self._sdir(stream)
        return sorted(n[:-5] for n in os.listdir(d)
                      if n.endswith(".json") and not n.startswith("."))

    def xread(self, stream, count, last_id="0", block_ms=0):
        deadline = time.monotonic() + block_ms / 1000.0
        d = self._sdir(stream)
        while True:
            out = []
            for rid in self._ids(stream):
                if rid <= last_id:
                    continue
                try:
                    with open(os.path.join(d, rid + ".json")) as f:
                        out.append((rid, json.load(f)))
                except (OSError, json.JSONDecodeError):
                    continue  # trimmed or mid-write by a racing producer
                if len(out) >= count:
                    break
            if out or time.monotonic() >= deadline:
                return out
            time.sleep(0.01)

    def xlen(self, stream):
        return len(self._ids(stream))

    def _remove_record(self, stream, rid):
        d = self._sdir(stream)
        for p in (os.path.join(d, rid + ".json"),
                  self._cpath(stream, rid)):  # no orphan claim dotfiles
            try:
                os.remove(p)
            except OSError:
                pass

    def xtrim(self, stream, maxlen):
        ids = self._ids(stream)
        for rid in ids[:max(0, len(ids) - maxlen)]:
            self._remove_record(stream, rid)

    def ack(self, stream, upto_id):
        for rid in self._ids(stream):
            if rid > upto_id:
                break
            self._remove_record(stream, rid)

    # -- exactly-once work claiming (fleet protocol) -------------------
    #
    # A claim is a dotfile next to the record (".c-<rid>.json" — hidden
    # from _ids) holding {"owner", "exp" (wall-clock lease deadline)}.
    # Claim files are born ATOMICALLY WITH FULL CONTENT via os.link from
    # a private temp file — link(2) fails with EEXIST when the path is
    # taken, which is the cross-process compare-and-claim: exactly one
    # replica wins a fresh record, and no reader ever sees a half-written
    # claim.  Lease-expiry takeover renames the expired claim to a
    # private tombstone first (again: exactly one renamer of that path
    # wins), verifies the tombstone is the expired claim it read, then
    # links its own claim in.  Two survivors reclaiming the same dead
    # replica's record therefore resolve atomically; only a >2-way
    # reclaim storm interleaved within the same few microseconds can
    # degrade to at-least-once (results are idempotent hset writes, and
    # the Redis transport gets true single-server atomicity).

    def _cpath(self, stream, rid):
        return os.path.join(self._sdir(stream), ".c-" + rid + ".json")

    @staticmethod
    def _read_claim(cpath):
        """(owner, exp) of a claim file, or None when absent/unreadable
        (unreadable cannot happen via the link protocol — treated as
        absent so a manually-corrupted claim does not wedge a record)."""
        try:
            with open(cpath) as f:
                doc = json.load(f)
            return str(doc.get("owner", "")), float(doc.get("exp", 0.0))
        except (OSError, ValueError):
            return None

    def _link_claim(self, cpath, owner, lease_ms) -> bool:
        """Atomically create ``cpath`` with a fresh lease; False when the
        path is already claimed."""
        tmp = cpath + ".tmp-" + uuid.uuid4().hex[:8]
        with open(tmp, "w") as f:
            json.dump({"owner": owner,
                       "exp": time.time() + lease_ms / 1000.0}, f)
        try:
            os.link(tmp, cpath)
            return True
        except OSError:
            return False
        finally:
            os.remove(tmp)

    def _try_claim(self, stream, rid, owner, lease_ms):
        """Claim one record; returns (rid, fields) or None (lost a race /
        live lease / record vanished).  Second element of the return is
        via self._claim_takeovers bookkeeping."""
        cpath = self._cpath(stream, rid)
        cur = self._read_claim(cpath)
        if cur is None:
            if not self._link_claim(cpath, owner, lease_ms):
                return None
        elif cur[1] <= time.time():
            # expired lease: tombstone-rename is the atomic takeover
            tomb = cpath + ".to-" + uuid.uuid4().hex[:8]
            try:
                os.rename(cpath, tomb)
            except OSError:
                return None  # another claimer already took it
            grabbed = self._read_claim(tomb)
            if grabbed is not None and grabbed != cur:
                # raced past a fresh re-claim: restore it (atomic —
                # link fails if yet another claim landed meanwhile)
                try:
                    os.link(tomb, cpath)
                except OSError:
                    pass
                os.remove(tomb)
                return None
            ok = self._link_claim(cpath, owner, lease_ms)
            try:
                os.remove(tomb)
            except OSError:
                pass
            if not ok:
                return None
            if cur[0] != owner:
                self._takeovers[owner] = self._takeovers.get(owner, 0) + 1
        else:
            return None  # live lease
        # claimed — but the record may have been trimmed/acked meanwhile
        try:
            with open(os.path.join(self._sdir(stream),
                                   rid + ".json")) as f:
                return rid, json.load(f)
        except (OSError, json.JSONDecodeError):
            try:
                os.remove(cpath)
            except OSError:
                pass
            return None

    def claim(self, stream, owner, count, lease_ms, block_ms=0):
        deadline = time.monotonic() + block_ms / 1000.0
        while True:
            out = []
            for rid in self._ids(stream):
                got = self._try_claim(stream, rid, owner, lease_ms)
                if got is None:
                    continue
                out.append(got)
                if len(out) >= count:
                    break
            if out or time.monotonic() >= deadline:
                return out
            time.sleep(0.01)  # cross-process spool: poll is the only wake

    def _take_own_claim(self, cpath, owner):
        """Atomically rename ``owner``'s claim off ``cpath``; returns the
        tombstone path, or None when the path is gone or holds someone
        else's claim (which is restored untouched).  rename(2) is the
        exclusivity: a takeover that raced past our last read cannot be
        clobbered, because only one renamer of the path wins."""
        tomb = cpath + ".ex-" + uuid.uuid4().hex[:8]
        try:
            os.rename(cpath, tomb)
        except OSError:
            return None  # a takeover owns the path right now
        grabbed = self._read_claim(tomb)
        if grabbed is None or grabbed[0] != owner:
            # raced: a survivor's fresh claim was at the path — restore
            # it (link fails only if yet another claim landed meanwhile)
            try:
                os.link(tomb, cpath)
            except OSError:
                pass
            try:
                os.remove(tomb)
            except OSError:
                pass
            return None
        return tomb

    def extend(self, stream, owner, ids, lease_ms):
        for rid in ids:
            cpath = self._cpath(stream, rid)
            cur = self._read_claim(cpath)
            now = time.time()
            # Renew via atomic rename-REPLACE (the path is never absent,
            # so a concurrent claimer can never read 'unclaimed' off a
            # live lease), but only while a 50ms stall guard remains
            # before expiry: a takeover is only legal AFTER expiry, so
            # the replace can only clobber a survivor's claim if this
            # process stalls longer than the guard between this check
            # and the rename — the same pause class the lease protocol
            # already concedes to at-least-once (results are idempotent
            # hset writes).  A lease inside the guard is left to ride
            # out (the keepalive beats at lease/3, far from the guard).
            if cur is None or cur[0] != owner or cur[1] - now <= 0.05:
                continue  # no longer (safely) ours — let the lease ride
            tmp = cpath + ".tmp-" + uuid.uuid4().hex[:8]
            with open(tmp, "w") as f:
                json.dump({"owner": owner,
                           "exp": now + lease_ms / 1000.0}, f)
            os.rename(tmp, cpath)

    def release(self, stream, owner, ids, done=False):
        d = self._sdir(stream)
        for rid in ids:
            cpath = self._cpath(stream, rid)
            cur = self._read_claim(cpath)
            if cur is None or cur[0] != owner:
                continue
            if done:
                # record first, claim second: a crash in between leaves
                # an orphan claim on a gone record, which _try_claim
                # already cleans up — never the reverse (an unclaimed
                # but served record would be re-served).  A takeover
                # racing the claim removal is harmless here: the record
                # is gone, so the survivor's claim is an orphan either
                # way.
                try:
                    os.remove(os.path.join(d, rid + ".json"))
                except OSError:
                    pass
                try:
                    os.remove(cpath)
                except OSError:
                    pass
            else:
                # requeue: take the path atomically first — deleting
                # blind could remove a survivor's just-taken-over claim
                # and hand the record to a THIRD replica mid-serve
                tomb = self._take_own_claim(cpath, owner)
                if tomb is not None:
                    try:
                        os.remove(tomb)
                    except OSError:
                        pass

    def unclaimed(self, stream):
        # ONE listdir, then read only the claim dotfiles actually
        # present (≈ replicas × batch_size) — NOT one failed open per
        # backlog record; a deep backlog is exactly when the autoscaler
        # polls this and must not slow down
        now = time.time()
        try:
            names = os.listdir(self._sdir(stream))
        except OSError:
            return 0
        recs = {n[:-5] for n in names
                if n.endswith(".json") and not n.startswith(".")}
        live = 0
        for n in names:
            if not (n.startswith(".c-") and n.endswith(".json")):
                continue  # tombstones/tmps never end in .json
            if n[3:-5] not in recs:
                continue  # orphan claim on a trimmed/acked record
            cur = self._read_claim(
                os.path.join(self._sdir(stream), n))
            if cur is not None and cur[1] > now:
                live += 1
        return len(recs) - live

    def pop_takeovers(self, owner):
        return self._takeovers.pop(owner, 0)

    _RATIO_TTL = 0.5  # seconds between spool re-scans

    def memory_ratio(self):
        """Spool bytes / max_bytes — the one broker that can actually fill a
        disk must report pressure so the server's xtrim backpressure path
        (server.py; semantics ClusterServing.scala:128-134) engages.

        The scan walks every spool file, and OTHER processes append to the
        spool (clients xadd from their own FileBroker instances), so an
        in-process byte counter can't work; instead the scan result is
        cached for ``_RATIO_TTL`` seconds to bound syscall cost per
        serving step."""
        now = time.monotonic()
        cached = getattr(self, "_ratio_cache", None)
        if cached is not None and now - cached[0] < self._RATIO_TTL:
            return cached[1]
        used = 0
        try:
            entries = os.listdir(self.root)
        except OSError:
            return 0.0
        for name in entries:
            if not name.startswith("stream-"):
                continue
            d = os.path.join(self.root, name)
            try:
                with os.scandir(d) as it:
                    for e in it:
                        try:
                            used += e.stat().st_size
                        except OSError:
                            pass
            except OSError:
                pass
        ratio = min(1.0, used / max(self.max_bytes, 1))
        self._ratio_cache = (now, ratio)
        return ratio

    def hset(self, key, mapping):
        p = self._hpath(key)
        cur = self.hgetall(key)
        cur.update(mapping)
        tmp = p + ".tmp-" + uuid.uuid4().hex[:8]
        with open(tmp, "w") as f:
            json.dump(cur, f)
        os.rename(tmp, p)

    def hgetall(self, key):
        try:
            with open(self._hpath(key)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return {}

    def delete(self, key):
        try:
            os.remove(self._hpath(key))
        except OSError:
            pass

    def keys(self, prefix):
        # filenames are the mangled keys ("/" -> "_"); the mangle is
        # idempotent, so returned keys round-trip through hgetall/delete
        # (uris containing "/" come back with "_")
        d = os.path.join(self.root, "hash")
        pfx = prefix.replace("/", "_")
        try:
            names = os.listdir(d)
        except OSError:
            return []
        return [n[:-5] for n in names
                if n.endswith(".json") and n.startswith(pfx)]


class RedisBroker(Broker):
    """The reference transport (Jedis in ClusterServing.scala:119).  Gated
    on the ``redis`` package; raises ImportError with guidance if absent."""

    def __init__(self, host: str = "localhost", port: int = 6379):
        try:
            import redis
        except ImportError as e:  # pragma: no cover - redis not in image
            raise ImportError(
                "RedisBroker requires the 'redis' package; use "
                "FileBroker/InMemoryBroker or install redis-py") from e
        self._r = redis.Redis(host=host, port=port, decode_responses=True)
        self._takeovers: dict[str, int] = {}
        # last lease claim() was called with: unclaimed() needs it to
        # tell expired (claimable) PEL entries from live in-flight ones
        self._last_lease_ms: int | None = None

    def xadd(self, stream, fields):  # pragma: no cover - needs server
        return self._r.xadd(stream, fields)

    def xread(self, stream, count, last_id="0", block_ms=0):
        # pragma: no cover - needs server
        res = self._r.xread({stream: last_id}, count=count,
                            block=block_ms or None)
        return [(rid, fields) for _, recs in res for rid, fields in recs]

    def xlen(self, stream):  # pragma: no cover
        return self._r.xlen(stream)

    def xtrim(self, stream, maxlen):  # pragma: no cover
        self._r.xtrim(stream, maxlen=maxlen, approximate=True)

    def ack(self, stream, upto_id):  # pragma: no cover
        # XTRIM MINID evicts ids strictly below minid, so pass the successor
        # of upto_id (redis ids are "<ms>-<seq>")
        ms, _, seq = upto_id.partition("-")
        succ = f"{ms}-{int(seq or 0) + 1}"
        self._r.xtrim(stream, minid=succ, approximate=False)

    # -- exactly-once work claiming: the Redis-native mapping is stream
    # consumer groups — XREADGROUP hands each entry to ONE consumer,
    # XAUTOCLAIM reassigns entries idle past the lease (the dead-replica
    # takeover), XACK+XDEL is release(done=True).
    _GROUP = "zoo-fleet"

    def _ensure_group(self, stream):  # pragma: no cover - needs server
        try:
            self._r.xgroup_create(stream, self._GROUP, id="0",
                                  mkstream=True)
        except Exception:
            pass  # BUSYGROUP: already exists

    def claim(self, stream, owner, count, lease_ms,
              block_ms=0):  # pragma: no cover - needs server
        self._ensure_group(stream)
        self._last_lease_ms = int(lease_ms)
        out = []
        # 1) reclaim entries whose consumer went idle past the lease
        try:
            res = self._r.xautoclaim(stream, self._GROUP, owner,
                                     min_idle_time=int(lease_ms),
                                     count=count)
            reclaimed = res[1] if isinstance(res, (list, tuple)) else []
        except Exception:
            reclaimed = []
        for rid, fields in reclaimed:
            out.append((rid, fields))
            self._takeovers[owner] = self._takeovers.get(owner, 0) + 1
        # 2) then fresh, never-delivered entries; never block when the
        # reclaim already produced records — a takeover drain must not
        # pay block_ms per cycle on top of the lease it waited out
        need = count - len(out)
        if need > 0:
            res = self._r.xreadgroup(self._GROUP, owner, {stream: ">"},
                                     count=need,
                                     block=(block_ms or None)
                                     if not out else None)
            for _, recs in res or []:
                out.extend(recs)
        return out

    def extend(self, stream, owner, ids,
               lease_ms):  # pragma: no cover - needs server
        # XCLAIM justid resets the idle clock without changing ownership
        if ids:
            try:
                self._r.xclaim(stream, self._GROUP, owner, min_idle_time=0,
                               message_ids=list(ids), justid=True)
            except Exception:
                pass

    def release(self, stream, owner, ids,
                done=False):  # pragma: no cover - needs server
        ids = list(ids)
        if not ids:
            return
        if done:
            self._r.xack(stream, self._GROUP, *ids)
            self._r.xdel(stream, *ids)
        # done=False: leave the entries in the group's PEL — XAUTOCLAIM
        # hands them to a survivor once the lease idles out.  (XACK here
        # would be WRONG: acked entries never re-deliver to the group.)
        # Requeue latency is therefore one lease on this transport.

    def unclaimed(self, stream):  # pragma: no cover - needs server
        try:
            info = self._r.xpending(stream, self._GROUP)
            pending = int(info.get("pending", 0)) if isinstance(info, dict) \
                else 0
            if pending and self._last_lease_ms:
                # PEL entries idle past the lease are a dead replica's
                # forfeited work — claimable demand the autoscaler must
                # see, NOT in-flight capacity; don't subtract them
                try:
                    expired = len(self._r.xpending_range(
                        stream, self._GROUP, min="-", max="+",
                        count=pending, idle=self._last_lease_ms))
                    pending -= min(pending, expired)
                except Exception:
                    pass  # older server/client without IDLE filtering
        except Exception:
            pending = 0
        return max(0, self.xlen(stream) - pending)

    def pop_takeovers(self, owner):  # pragma: no cover - needs server
        return self._takeovers.pop(owner, 0)

    def hset(self, key, mapping):  # pragma: no cover
        self._r.hset(key, mapping=mapping)

    def hset_many(self, items):  # pragma: no cover
        # MULTI-free pipeline: one network round-trip per micro-batch
        # (the reference scripts its write-back the same way,
        # RedisUtils.scala)
        p = self._r.pipeline(transaction=False)
        for key, mapping in items:
            p.hset(key, mapping=mapping)
        p.execute()

    def hgetall(self, key):  # pragma: no cover
        return self._r.hgetall(key)

    def delete(self, key):  # pragma: no cover
        self._r.delete(key)

    def keys(self, prefix):  # pragma: no cover
        # _type="hash": a shared db may hold non-hash keys under the same
        # prefix; hgetall on those would raise WRONGTYPE mid-dequeue
        return list(self._r.scan_iter(match=prefix + "*", _type="hash"))

    def memory_ratio(self):  # pragma: no cover
        info = self._r.info("memory")
        mx = int(info.get("maxmemory", 0))
        return (int(info["used_memory"]) / mx) if mx else 0.0


def connect_broker(spec) -> Broker:
    """Build a broker from a spec: a Broker instance (returned as-is), a
    ``dir:`` / plain path (FileBroker), ``memory``, or ``host:port``
    (RedisBroker)."""
    if isinstance(spec, Broker):
        return spec
    if spec is None or spec == "memory":
        return InMemoryBroker()
    spec = str(spec)
    if spec.startswith("dir:"):
        return FileBroker(spec[4:])
    if ":" in spec and not os.sep in spec:
        host, port = spec.rsplit(":", 1)
        return RedisBroker(host, int(port))
    return FileBroker(spec)
