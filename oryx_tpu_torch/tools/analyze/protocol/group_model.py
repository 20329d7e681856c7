"""Consumer-group protocol model: join/heartbeat-TTL/leave/
crash, the expansion-hysteresis window, the closing-consumer rule, and
committed-offset resume — the state machine behind
``ConsumeDataIterator`` (transport/topic.py) and the broker group
sessions (file/memory mtime-TTL, tcp server monotonic-TTL).

The model is deliberately small — C consumers, P partitions, R records
per partition, committed-offset start mode — because the historical
bugs all fit inside it:

* **rebalance hysteresis**: growing the assignment on a single
  membership read turns a transient view (a heartbeat racing the TTL
  sweep) into duplicate consumption. Modelled by the ``blip.*`` fault
  actions: one membership read of one observer sees a live peer
  missing. The documented defense is that a transient hole cannot
  survive both reads of the 50 ms hysteresis window (TTL is 30 s, the
  sweep race is one inconsistent read) — so the blip arms only against
  a *first* read, and the ``skip-hysteresis`` variant, which accepts
  the blipped expansion immediately, is the re-introduced bug.
* **closing-consumer claim**: ``close()`` racing a peer's
  ``leave_group`` used to skip the hysteresis entirely (its entry
  condition required not-closed) and take the raw expanded view. The
  ``closing-claims`` variant re-introduces exactly that branch.

Consumers ``c0``/``c1`` may close cleanly; ``c2`` only crashes — the
liveness drain needs one consumer whose fair future keeps consuming.

State variables (see :class:`machine.S`): broker-side ``members`` view
with an ``epoch`` bumped on every membership change; per-consumer
status/incarnation/assignment/pending-expansion/read positions; the
group's ``committed`` offsets; and two history variables the invariants
read — ``delivered`` (which (consumer, incarnation) delivered each
record) and ``closing_violation``.
"""

from __future__ import annotations

from oryx_tpu_torch.tools.analyze.protocol.machine import S, Action, Model, Site, tuple_set

CONSUMERS = ("c0", "c1", "c2")
# only c0 may close voluntarily: every closing-rule scenario (including
# the closing-claims rediscovery, which expands a closing c0 by
# crashing/expiring BOTH other members) needs just one closable
# consumer, and each additional close/finish_close pair multiplies the
# interleaving space. c1/c2 still leave via crash + TTL expiry.
CLOSABLE = ("c0",)
PARTITIONS = 2
# one record per partition: every invariant here (duplicate delivery,
# closing claims, ownership, delivery liveness) needs at most one
# record, and the second record roughly squares the state space
RECORDS = 1

#: variants re-introducing the historical bugs, by name
VARIANTS = ("skip-hysteresis", "closing-claims")

_TOPIC = "oryx_tpu_torch/transport/topic.py"
_NET = "oryx_tpu_torch/transport/netbroker.py"

SITES = {
    "assigned": Site(_TOPIC, "ConsumeDataIterator._assigned", 1019,
                     "self._closed.wait(0.05)"),
    "closing_rule": Site(_TOPIC, "ConsumeDataIterator._assigned", 1004,
                         "must never claim new partitions"),
    "view": Site(_TOPIC, "ConsumeDataIterator._assignment_from_view", 1067,
                 "partitions_for_member"),
    "ranks": Site(_TOPIC, "partitions_for_member", 191),
    "next": Site(_TOPIC, "ConsumeDataIterator.__next__", 1190,
                 "self._processed[p] = next_off"),
    "resume": Site(_TOPIC, "ConsumeDataIterator._offset_of", 1072,
                   'self._start == "committed"'),
    "hygiene": Site(_TOPIC, "ConsumeDataIterator._assigned", 1053,
                    "rebalance hygiene"),
    "close": Site(_TOPIC, "ConsumeDataIterator.close", 1193,
                  "self._closed.set()"),
    "leave": Site(_TOPIC, "ConsumeDataIterator.close", 1198, "leave_group"),
    "heartbeat": Site(_TOPIC, "ConsumeDataIterator._assigned", 1001,
                      "join_group"),
    "commit_abc": Site(_TOPIC, "Broker.set_offset", 323),
    "commit_mem": Site(_TOPIC, "MemoryBroker.set_offset", 494),
    "commit_file": Site(_TOPIC, "FileBroker.set_offset", 795),
    "commit_net": Site(_NET, "NetBrokerClient.set_offset", 751),
    "commit_srv": Site(_NET, "NetBrokerServer._op_set_offset", 438),
    "ttl_mem": Site(_TOPIC, "MemoryBroker.group_members", 511,
                    "GROUP_MEMBER_TTL_SEC"),
    "ttl_file": Site(_TOPIC, "FileBroker.group_members", 826,
                     "GROUP_MEMBER_TTL_SEC"),
    "ttl_srv": Site(_NET, "NetBrokerServer._op_group_members", 458,
                    "group_ttl_sec"),
    "join_file": Site(_TOPIC, "FileBroker.join_group", 807),
    "join_srv": Site(_NET, "NetBrokerServer._op_join_group", 444,
                     "monotonic"),
    "leave_file": Site(_TOPIC, "FileBroker.leave_group", 812),
    "leave_srv": Site(_NET, "NetBrokerServer._op_leave_group", 451),
}


def _target(name: str, view: frozenset, n_partitions: int) -> frozenset:
    """partitions_for_member (topic.py:184): sorted-rank round-robin."""
    members = sorted(view | {name})
    rank = members.index(name)
    return frozenset(
        p for p in range(n_partitions) if p % len(members) == rank
    )


def _initial() -> S:
    cons = tuple(
        S(
            name=name,
            status="live",  # live | closing | stopped | crashed
            inc=0,
            assigned=_target(name, frozenset(CONSUMERS), PARTITIONS),
            pending=None,  # first-read target awaiting the confirm read
            pos=(None,) * PARTITIONS,  # per-partition read pos; None=lazy
            seen_epoch=0,
            view_ok=True,  # last membership read used the true view
            # partitions GAINED by a read whose view was falsified by a
            # blip — provably always empty at HEAD (hysteresis demands a
            # genuine confirm read behind every gain); non-empty only in
            # the buggy variants
            blip_gain=frozenset(),
            close_assigned=None,  # assignment snapshot at close()
        )
        for name in CONSUMERS
    )
    return S(
        members=frozenset(CONSUMERS),
        epoch=0,
        # per-observer one-read transient view hole: blips[i] is the
        # member name consumer i's NEXT membership read will fail to
        # see, or None. Keyed per observer so two consumers' reads stay
        # independent under the partial-order reduction.
        blips=(None,) * len(CONSUMERS),
        blip_used=False,
        committed=(0,) * PARTITIONS,
        delivered=tuple(
            (frozenset(),) * RECORDS for _ in range(PARTITIONS)
        ),
        cons=cons,
        closing_violation="",
        dup_violation="",
    )


def _consumer_index(name: str) -> int:
    return CONSUMERS.index(name)


def _accept(me: S, target: frozenset, epoch: int, view_ok: bool) -> S:
    # rebalance hygiene (topic.py:1047): a partition lost to another
    # member leaves no residue in the read/processed maps
    pos = tuple(
        None if (p in me.assigned and p not in target) else me.pos[p]
        for p in range(PARTITIONS)
    )
    # a genuine-view read re-legitimizes the whole assignment; a
    # falsified one taints exactly the partitions it granted
    gain = frozenset() if view_ok else (target - me.assigned)
    return me.updated(
        assigned=target, pending=None, pos=pos,
        seen_epoch=epoch, view_ok=view_ok, blip_gain=gain,
    )


def _mk_read_members(name: str, variant: str) -> Action:
    i = _consumer_index(name)

    def fire(s: S) -> "S | None":
        me = s.cons[i]
        if me.status not in ("live", "closing"):
            return None
        blip = s.blips[i]
        view = s.members
        consumed = False
        if blip is not None:
            view = view - frozenset((blip,))
            consumed = True
        view_ok = not consumed
        target = _target(name, view, PARTITIONS)
        updates: dict = {}
        if consumed:
            updates["blips"] = tuple_set(s.blips, i, None)
        if me.pending is not None:
            # second half of the hysteresis window: the confirm read
            # (topic.py:1036). A consumer that closed inside the window
            # clamps to its pre-window assignment; otherwise a still-
            # grown confirm is a genuine takeover and lands wholesale,
            # and a healed view keeps only first∩confirm.
            if me.status == "closing":
                nxt = _accept(me, me.pending & me.assigned, s.epoch, view_ok)
            elif target - me.assigned:
                nxt = _accept(me, target, s.epoch, view_ok)
            else:
                nxt = _accept(me, me.pending & target, s.epoch, view_ok)
        else:
            grown = target - me.assigned
            if not grown:
                nxt = _accept(me, target, s.epoch, view_ok)
            elif variant == "closing-claims" and me.status == "closing":
                # closing-claims bug, re-introduced: closed-set skipped the
                # hysteresis and took the raw expanded view
                nxt = _accept(me, target, s.epoch, view_ok)
            elif me.status == "closing":
                # HEAD closing rule (topic.py:998): never expand
                nxt = _accept(me, target & me.assigned, s.epoch, view_ok)
            elif variant == "skip-hysteresis":
                # skip-hysteresis bug, re-introduced: expansion on a single read
                nxt = _accept(me, target, s.epoch, view_ok)
            else:
                # HEAD: a grown view only proposes; acceptance needs the
                # confirm read one beat later (topic.py:1013)
                nxt = me.updated(
                    pending=target, seen_epoch=s.epoch, view_ok=view_ok,
                )
        updates["cons"] = tuple_set(s.cons, i, nxt)
        return s.updated(**updates)

    return Action(
        name=f"{name}.read_members",
        fire=fire,
        vars=frozenset({f"c:{name}", "members", f"blip:{name}"}),
        writes=frozenset({f"c:{name}", f"blip:{name}"}),
        sites=(
            SITES["assigned"], SITES["closing_rule"], SITES["view"],
            SITES["ranks"], SITES["hygiene"], SITES["heartbeat"],
            SITES["join_file"], SITES["join_srv"],
        ),
    )


def _mk_poll(name: str, p: int) -> Action:
    i = _consumer_index(name)

    def fire(s: S) -> "S | None":
        me = s.cons[i]
        if me.status not in ("live", "closing"):
            return None
        if me.pending is not None:
            return None  # thread is sleeping inside the hysteresis window
        if p not in me.assigned:
            return None
        off = me.pos[p] if me.pos[p] is not None else s.committed[p]
        if off >= RECORDS:
            return None
        prior = s.delivered[p][off]
        entry = prior | {(name, me.inc)}
        delivered = tuple_set(
            s.delivered, p, tuple_set(s.delivered[p], off, entry)
        )
        nxt = me.updated(pos=tuple_set(me.pos, p, off + 1))
        violation = s.closing_violation
        if (
            not violation
            and me.status == "closing"
            and me.close_assigned is not None
            and p not in me.close_assigned
        ):
            violation = (
                f"closing consumer {name} delivered p{p}#{off}, a "
                f"partition outside its close-time assignment "
                f"{sorted(me.close_assigned)}"
            )
        # duplicate-delivery check, at delivery time: this poll races a
        # prior delivery by a consumer that is STILL a live owner of p,
        # and one of the two claims to p rests on a blip-falsified gain.
        # Stale-view redelivery and lame-duck drains are the documented
        # at-least-once windows and carry no falsified gain.
        dup = s.dup_violation
        if not dup:
            for dn, di in prior:
                if dn == name or di < 0:  # self or pruned-ledger sentinel
                    continue
                other = s.cons[_consumer_index(dn)]
                if (
                    other.status == "live"
                    and other.inc == di
                    and p in other.assigned
                    and (p in me.blip_gain or p in other.blip_gain)
                ):
                    dup = (
                        f"record p{p}#{off} delivered by both {dn} and "
                        f"{name} while both live and owning p{p}, with "
                        f"the ownership overlap created by a "
                        f"single-read (blipped) expansion — duplicate "
                        f"outside the documented at-least-once windows"
                    )
                    break
        return s.updated(
            delivered=delivered,
            cons=tuple_set(s.cons, i, nxt),
            closing_violation=violation,
            dup_violation=dup,
        )

    return Action(
        name=f"{name}.poll.p{p}",
        fire=fire,
        vars=frozenset({f"c:{name}", f"p:{p}", "committed"}),
        writes=frozenset({f"c:{name}", f"p:{p}"}),
        sites=(SITES["next"], SITES["resume"]),
    )


def _mk_commit(name: str) -> Action:
    i = _consumer_index(name)

    def fire(s: S) -> "S | None":
        me = s.cons[i]
        if me.status not in ("live", "closing") or me.pending is not None:
            return None
        committed = list(s.committed)
        changed = False
        for p in me.assigned:
            pos = me.pos[p]
            if pos is not None and pos > committed[p]:
                committed[p] = pos
                changed = True
        if not changed:
            return None
        return s.updated(committed=tuple(committed))

    return Action(
        name=f"{name}.commit",
        fire=fire,
        vars=frozenset({f"c:{name}", "committed"}),
        writes=frozenset({"committed"}),
        sites=(
            SITES["commit_abc"], SITES["commit_mem"], SITES["commit_file"],
            SITES["commit_net"], SITES["commit_srv"],
        ),
    )


def _mk_close(name: str) -> Action:
    i = _consumer_index(name)

    def fire(s: S) -> "S | None":
        me = s.cons[i]
        if me.status != "live":
            return None
        nxt = me.updated(status="closing", close_assigned=me.assigned)
        return s.updated(cons=tuple_set(s.cons, i, nxt))

    return Action(
        name=f"{name}.close",
        fire=fire,
        vars=frozenset({f"c:{name}"}),
        progress=False,  # voluntary teardown is not required for liveness
        sites=(SITES["close"],),
    )


def _mk_finish_close(name: str) -> Action:
    i = _consumer_index(name)

    def fire(s: S) -> "S | None":
        me = s.cons[i]
        if me.status != "closing":
            return None
        nxt = me.updated(status="stopped")
        return s.updated(
            cons=tuple_set(s.cons, i, nxt),
            members=s.members - frozenset((name,)),
            epoch=s.epoch + 1,
        )

    return Action(
        name=f"{name}.finish_close",
        fire=fire,
        vars=frozenset({f"c:{name}", "members"}),
        # fairness: once closing, close() terminates and leaves the
        # group — the drain must be allowed to finish it
        sites=(SITES["leave"], SITES["leave_file"], SITES["leave_srv"]),
    )


def _mk_crash(name: str) -> Action:
    i = _consumer_index(name)

    def fire(s: S) -> "S | None":
        me = s.cons[i]
        if me.status not in ("live", "closing"):
            return None
        nxt = me.updated(status="crashed", pending=None)
        return s.updated(cons=tuple_set(s.cons, i, nxt))

    return Action(
        name=f"{name}.crash",
        fire=fire,
        vars=frozenset({f"c:{name}"}),
        kind="crash",
        progress=False,
    )


def _mk_ttl_expire(name: str) -> Action:
    i = _consumer_index(name)

    def fire(s: S) -> "S | None":
        me = s.cons[i]
        if me.status != "crashed" or name not in s.members:
            return None
        return s.updated(
            members=s.members - frozenset((name,)), epoch=s.epoch + 1,
        )

    return Action(
        name=f"{name}.ttl_expire",
        fire=fire,
        vars=frozenset({f"c:{name}", "members"}),
        writes=frozenset({"members"}),
        sites=(SITES["ttl_mem"], SITES["ttl_file"], SITES["ttl_srv"]),
    )


def _mk_restart(name: str) -> Action:
    i = _consumer_index(name)

    def fire(s: S) -> "S | None":
        me = s.cons[i]
        if me.status != "crashed":
            return None
        nxt = me.updated(
            status="live", inc=me.inc + 1, assigned=frozenset(),
            pending=None, pos=(None,) * PARTITIONS,
            seen_epoch=-1, view_ok=False, close_assigned=None,
            blip_gain=frozenset(),
        )
        updates = {"cons": tuple_set(s.cons, i, nxt)}
        if name not in s.members:
            updates["members"] = s.members | frozenset((name,))
            updates["epoch"] = s.epoch + 1
        return s.updated(**updates)

    return Action(
        name=f"{name}.restart",
        fire=fire,
        vars=frozenset({f"c:{name}", "members"}),
        kind="restart",
        sites=(SITES["heartbeat"], SITES["join_file"], SITES["join_srv"]),
    )


def _mk_blip(observer: str, missing: str) -> Action:
    oi = _consumer_index(observer)
    mi = _consumer_index(missing)

    def fire(s: S) -> "S | None":
        if s.blip_used or s.blips[oi] is not None:
            return None
        obs = s.cons[oi]
        # the transient hole cannot persist into the confirm read (TTL is
        # 30 s; the sweep race is one inconsistent read): arm only
        # against a first read
        if obs.status not in ("live", "closing") or obs.pending is not None:
            return None
        miss = s.cons[mi]
        if miss.status != "live" or missing not in s.members:
            return None
        return s.updated(
            blips=tuple_set(s.blips, oi, missing), blip_used=True
        )

    return Action(
        name=f"blip.{observer}.drops.{missing}",
        fire=fire,
        vars=frozenset({
            f"blip:{observer}", "blip_used", f"c:{observer}",
            f"c:{missing}", "members",
        }),
        writes=frozenset({f"blip:{observer}", "blip_used"}),
        kind="fault",
        progress=False,
        sites=(SITES["ttl_srv"],),  # the TTL sweep race being modelled
    )


# ---------------------------------------------------------------------------
# Invariants
# ---------------------------------------------------------------------------


def _inv_no_duplicate_delivery(s: S) -> "str | None":
    """No duplicate delivery outside the documented at-least-once
    windows. The windows that ARE documented: redelivery of uncommitted
    work after a crash or clean reassignment, a stale-view consumer
    delivering one last batch before its next heartbeat read sheds the
    partition, and a closing lame-duck draining its clamped assignment
    alongside the new owner. What HEAD's expansion hysteresis is
    DESIGNED to make impossible is an ownership overlap minted by a
    single falsified membership read — every gain must be backed by a
    genuine confirm read, so ``blip_gain`` stays empty at HEAD. The
    check runs at delivery time inside the poll action (this predicate
    just reports the recorded history), and fires only when the two
    deliverers are simultaneously live owners with one claim resting on
    a blipped gain — the skip-hysteresis bug."""
    return s.dup_violation or None


def _inv_closing_claim(s: S) -> "str | None":
    return s.closing_violation or None


def _inv_exclusive_ownership(s: S) -> "str | None":
    """After quiesce — no pending blip, every live consumer has read the
    TRUE membership view at the current epoch and holds no half-open
    hysteresis window — partition ownership among LIVE consumers must
    be exclusive. Closing consumers are lame ducks: they clamp to their
    close-time assignment and drain it while the live group reassigns,
    which is the documented handoff overlap — claiming anything BEYOND
    that clamp is the separate closing-consumer-claim invariant."""
    active = [c for c in s.cons if c.status == "live"]
    if any(b is not None for b in s.blips):
        return None
    for c in active:
        if c.pending is not None or c.seen_epoch != s.epoch or not c.view_ok:
            return None
    owners: dict = {}
    for c in active:
        for p in c.assigned:
            if p in owners:
                return (
                    f"partition p{p} owned by both {owners[p]} and "
                    f"{c.name} after quiesce"
                )
            owners[p] = c.name
    return None


def _live_all_delivered(s: S) -> "str | None":
    missing = [
        f"p{p}#{off}"
        for p in range(PARTITIONS)
        for off in range(RECORDS)
        if not s.delivered[p][off]
    ]
    if missing:
        return (
            "records never delivered once crashes stopped: "
            + ", ".join(missing)
        )
    return None


# ---------------------------------------------------------------------------
# Model factory
# ---------------------------------------------------------------------------


#: sentinel deliverer recording "this record WAS delivered" after every
#: accountable deliverer is gone (dead incarnation / stopped consumer)
_GONE = ("*", -1)


def _canonicalize(s: S) -> S:
    """Map behaviorally-identical states to one representative. Three
    exact quotients (each provably invisible to every action, guard and
    invariant in this model):

    * **Epoch rebase** — only seen_epoch == epoch comparisons exist, so
      uniformly shifting all non-sentinel epoch counters changes
      nothing; shift the smallest to 0 to bound the counter.
    * **Lazy-pos** — a read position equal to the committed offset is
      indistinguishable from the lazy ``None`` (the next poll resumes
      from the committed offset either way; topic.py:1066).
    * **Delivery-ledger pruning** — the duplicate-delivery check only
      ever matches deliverers that are live/closing at their CURRENT
      incarnation; entries of dead incarnations or stopped consumers
      are permanently inert (an incarnation never recurs), and the
      liveness predicate needs only non-emptiness. Replace inert-only
      cells with a single sentinel entry.
    """
    seen = [c.seen_epoch for c in s.cons if c.seen_epoch >= 0]
    base = min([s.epoch] + seen)
    updates: dict = {}
    cons = s.cons
    if base:
        cons = tuple(
            c if c.seen_epoch < 0 else c.updated(seen_epoch=c.seen_epoch - base)
            for c in cons
        )
        updates["epoch"] = s.epoch - base
    lazy = tuple(
        c.updated(pos=tuple(
            None if c.pos[p] == s.committed[p] else c.pos[p]
            for p in range(PARTITIONS)
        )) if any(c.pos[p] is not None and c.pos[p] == s.committed[p]
                  for p in range(PARTITIONS)) else c
        for c in cons
    )
    if lazy != s.cons:
        updates["cons"] = lazy

    by_name = {c.name: c for c in lazy}

    def prune(entry: frozenset) -> frozenset:
        if not entry:
            return entry
        kept = frozenset(
            (dn, di)
            for dn, di in entry
            if dn != _GONE[0]
            and di == by_name[dn].inc
            and by_name[dn].status in ("live", "closing")
        )
        return kept or frozenset((_GONE,))

    delivered = tuple(
        tuple(prune(cell) for cell in part) for part in s.delivered
    )
    if delivered != s.delivered:
        updates["delivered"] = delivered
    return s.updated(**updates) if updates else s


def build(variant: str = "") -> Model:
    if variant not in ("",) + VARIANTS:
        raise ValueError(f"unknown consumer-group variant {variant!r}")
    actions = []
    for name in CONSUMERS:
        actions.append(_mk_read_members(name, variant))
        actions.append(_mk_commit(name))
        actions.append(_mk_crash(name))
        actions.append(_mk_ttl_expire(name))
        actions.append(_mk_restart(name))
        for p in range(PARTITIONS):
            actions.append(_mk_poll(name, p))
    for name in CLOSABLE:
        actions.append(_mk_close(name))
        actions.append(_mk_finish_close(name))
    for observer in CONSUMERS:
        for missing in CONSUMERS:
            if observer != missing:
                actions.append(_mk_blip(observer, missing))
    return Model(
        name="consumer-group",
        variant=variant,
        initial=_initial(),
        actions=tuple(actions),
        invariants=(
            ("no-duplicate-delivery", _inv_no_duplicate_delivery),
            ("closing-consumer-claim", _inv_closing_claim),
            ("exclusive-ownership-at-quiesce", _inv_exclusive_ownership),
        ),
        liveness=("all-records-delivered", _live_all_delivered),
        canonicalize=_canonicalize,
    )
