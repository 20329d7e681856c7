"""Broker append-path model: idempotence tokens,
lost-response retry, and torn-tail truncate-recovery racing first-touch
appends — the state machine behind ``TopicProducerImpl.send`` (one
token per LOGICAL send, minted outside the retry loop, topic.py:865),
the tcp server's ``_op_append`` token dedup (netbroker.py:359), and
``FileBroker``'s first-touch tail recovery (topic.py:635/654).

Two logical sends flow through a single-partition broker. A send's
life: request in flight -> server writes the framed record (torn until
the fsync/complete step) -> response in flight -> acked. The adversary
may lose one response per send; the producer retries with the SAME
token. The broker may crash (tearing a mid-write record and dropping
its in-memory dedup table, exactly like the real tcp server) and
restart, after which the first touch must run tail recovery before any
append lands.

Variants re-introducing bugs:

* ``no-token-dedup`` — the lost-response hole: the server applies a
  retried append it has already applied. ``no-duplicate-append`` fires
  with no crash anywhere in the schedule.
* ``recover-flag-early`` — the review catch on the recovery gate:
  publishing the recovered flag before the truncate runs lets a racing
  first-touch append (and its ack!) land on the torn tail and then be
  cut by the in-flight truncate — ``no-acked-record-loss`` fires.

The dedup table is in-memory in the real server, so a broker crash
legitimately reopens the duplicate window; the ``no-duplicate-append``
invariant therefore excuses sends whose in-flight window crossed a
broker crash (`crossed_crash`), mirroring the documented at-least-once
contract, and the HEAD model must be clean everywhere else.
"""

from __future__ import annotations

from oryx_tpu_torch.tools.analyze.protocol.machine import S, Action, Model, Site, tuple_set

SENDS = ("s1", "s2")
MAX_ATTEMPTS = 4  # >= 1 + possible losses (1 adversarial + 2 crash-induced)

VARIANTS = ("no-token-dedup", "recover-flag-early")

_TOPIC = "oryx_tpu_torch/transport/topic.py"
_NET = "oryx_tpu_torch/transport/netbroker.py"

SITES = {
    "mint": Site(_TOPIC, "TopicProducerImpl.send", 871,
                 "token = uuid.uuid4().hex"),
    "retry": Site(_TOPIC, "TopicProducerImpl.send", 894,
                  "resilience.default_policy().call"),
    "append_abc": Site(_TOPIC, "Broker.append", 278),
    "append_file": Site(_TOPIC, "FileBroker.append", 575),
    "append_net": Site(_NET, "NetBrokerClient.append", 709),
    "dedup": Site(_NET, "NetBrokerServer._op_append", 375,
                  "token in self._applied_tokens"),
    "record": Site(_NET, "NetBrokerServer._op_append", 382,
                   "self._applied_tokens[token] = None"),
    "fsync": Site(_TOPIC, "FileBroker._maybe_fsync", 613),
    "gate": Site(_TOPIC, "FileBroker._ensure_recovered", 641,
                 "threading.Event"),
    "scan": Site(_TOPIC, "FileBroker._recover_tail", 660, "ftruncate"),
}


def _initial() -> S:
    return S(
        # log: tuple of (send_id, complete) — complete=False is a torn
        # (partially written, unframed-tail) record
        log=(),
        tokens=frozenset(),  # server-side applied idempotence tokens
        wip=None,  # send id currently mid-write (under the append flock)
        up=True,
        recovered=True,
        pending_cut=None,  # recover-flag-early variant: truncate length
        sends=tuple(
            S(
                name=name,
                # new | req (request in flight) | resp (response in
                # flight) | lost (response lost) | acked
                phase="new",
                attempts=0,
                lost_used=False,  # one adversarial response loss per send
                crossed_crash=False,  # in-flight window crossed a crash
            )
            for name in SENDS
        ),
    )


def _send_index(name: str) -> int:
    return SENDS.index(name)


def _ready(s: S) -> bool:
    """Server can take append work: up, recovery complete (HEAD), or
    recovered-flag published (the buggy variant's whole point)."""
    return s.up and s.recovered


def _mk_send(name: str) -> Action:
    i = _send_index(name)

    def fire(s: S) -> "S | None":
        me = s.sends[i]
        if me.phase != "new":
            return None
        nxt = me.updated(phase="req", attempts=1)
        return s.updated(sends=tuple_set(s.sends, i, nxt))

    return Action(
        name=f"prod.send.{name}",
        fire=fire,
        vars=frozenset({f"s:{name}"}),
        sites=(SITES["mint"], SITES["append_abc"], SITES["append_net"]),
    )


def _mk_write(name: str, variant: str) -> Action:
    i = _send_index(name)

    def fire(s: S) -> "S | None":
        me = s.sends[i]
        if me.phase != "req" or not _ready(s) or s.wip is not None:
            return None
        if variant != "no-token-dedup" and name in s.tokens:
            # idempotence: already applied, response was lost — ack
            # without re-appending (netbroker.py:365)
            nxt = me.updated(phase="resp")
            return s.updated(sends=tuple_set(s.sends, i, nxt))
        return s.updated(log=s.log + ((name, False),), wip=name)

    return Action(
        name=f"srv.write.{name}",
        fire=fire,
        vars=frozenset({f"s:{name}", "log", "srv"}),
        sites=(SITES["dedup"], SITES["append_file"]),
    )


def _mk_complete(name: str) -> Action:
    i = _send_index(name)

    def fire(s: S) -> "S | None":
        me = s.sends[i]
        if s.wip != name or not s.up:
            return None
        log = tuple(
            (sid, True) if (sid == name and not done) else (sid, done)
            for sid, done in s.log
        )
        nxt = me.updated(phase="resp")
        return s.updated(
            log=log, wip=None, tokens=s.tokens | {name},
            sends=tuple_set(s.sends, i, nxt),
        )

    return Action(
        name=f"srv.complete.{name}",
        fire=fire,
        vars=frozenset({f"s:{name}", "log", "srv"}),
        sites=(SITES["fsync"], SITES["record"]),
    )


def _mk_lose(name: str) -> Action:
    i = _send_index(name)

    def fire(s: S) -> "S | None":
        me = s.sends[i]
        if me.phase != "resp" or me.lost_used:
            return None
        nxt = me.updated(phase="lost", lost_used=True)
        return s.updated(sends=tuple_set(s.sends, i, nxt))

    return Action(
        name=f"net.lose_response.{name}",
        fire=fire,
        vars=frozenset({f"s:{name}"}),
        kind="fault",
        progress=False,
    )


def _mk_ack(name: str) -> Action:
    i = _send_index(name)

    def fire(s: S) -> "S | None":
        me = s.sends[i]
        if me.phase != "resp":
            return None
        nxt = me.updated(phase="acked")
        return s.updated(sends=tuple_set(s.sends, i, nxt))

    return Action(
        name=f"prod.ack.{name}",
        fire=fire,
        vars=frozenset({f"s:{name}"}),
        sites=(SITES["append_net"],),
    )


def _mk_retry(name: str) -> Action:
    i = _send_index(name)

    def fire(s: S) -> "S | None":
        me = s.sends[i]
        if me.phase != "lost" or me.attempts >= MAX_ATTEMPTS:
            return None
        # SAME token: minted once per logical send, outside the retry
        nxt = me.updated(phase="req", attempts=me.attempts + 1)
        return s.updated(sends=tuple_set(s.sends, i, nxt))

    return Action(
        name=f"prod.retry.{name}",
        fire=fire,
        vars=frozenset({f"s:{name}"}),
        sites=(SITES["retry"], SITES["mint"]),
    )


def _mk_crash() -> Action:
    def fire(s: S) -> "S | None":
        if not s.up:
            return None
        sends = tuple(
            m.updated(phase="lost", crossed_crash=True)
            if m.phase == "resp"
            else (m.updated(crossed_crash=True) if m.phase in ("req", "lost") else m)
            for m in s.sends
        )
        # the torn mid-write record stays in the log; the in-memory
        # dedup table dies with the process (netbroker.py:169)
        return s.updated(
            up=False, wip=None, recovered=False, pending_cut=None,
            tokens=frozenset(), sends=sends,
        )

    return Action(
        name="srv.crash",
        fire=fire,
        vars=frozenset({"srv", "log", "s:s1", "s:s2"}),
        kind="crash",
        progress=False,
    )


def _mk_restart() -> Action:
    def fire(s: S) -> "S | None":
        if s.up:
            return None
        return s.updated(up=True)

    return Action(
        name="srv.restart",
        fire=fire,
        vars=frozenset({"srv"}),
        kind="restart",
    )


def _keep_length(log: tuple) -> int:
    """Backward scan (topic.py:654): keep up to the last complete
    record; anything after it is torn tail."""
    keep = len(log)
    while keep and not log[keep - 1][1]:
        keep -= 1
    return keep


def _mk_recover(variant: str) -> "list[Action]":
    if variant != "recover-flag-early":
        def fire(s: S) -> "S | None":
            if not s.up or s.recovered:
                return None
            # HEAD: scan + truncate run to completion under the
            # first-touch gate; racing touchers block on the Event that
            # is set only after the truncate (topic.py:635)
            return s.updated(log=s.log[: _keep_length(s.log)], recovered=True)

        return [Action(
            name="srv.recover",
            fire=fire,
            vars=frozenset({"srv", "log"}),
            sites=(SITES["gate"], SITES["scan"]),
        )]

    def fire_mark(s: S) -> "S | None":
        if not s.up or s.recovered:
            return None
        # BUG variant: the recovered flag (and with it the append path)
        # is published with the truncate still pending
        return s.updated(recovered=True, pending_cut=_keep_length(s.log))

    def fire_cut(s: S) -> "S | None":
        if not s.up or s.pending_cut is None:
            return None
        return s.updated(log=s.log[: s.pending_cut], pending_cut=None)

    return [
        Action(
            name="srv.recover_mark",
            fire=fire_mark,
            vars=frozenset({"srv", "log"}),
            sites=(SITES["gate"],),
        ),
        Action(
            name="srv.recover_cut",
            fire=fire_cut,
            vars=frozenset({"srv", "log"}),
            sites=(SITES["scan"],),
        ),
    ]


# ---------------------------------------------------------------------------
# Invariants
# ---------------------------------------------------------------------------


def _complete_count(s: S, name: str) -> int:
    return sum(1 for sid, done in s.log if sid == name and done)


def _inv_no_duplicate_append(s: S) -> "str | None":
    for i, name in enumerate(SENDS):
        if _complete_count(s, name) > 1 and not s.sends[i].crossed_crash:
            return (
                f"logical send {name} appended "
                f"{_complete_count(s, name)} times with no broker crash "
                f"in its window — token dedup failed"
            )
    return None


def _inv_no_acked_loss(s: S) -> "str | None":
    for i, name in enumerate(SENDS):
        if s.sends[i].phase == "acked" and _complete_count(s, name) == 0:
            return (
                f"send {name} was acknowledged but has no complete "
                f"record in the log — acked-record loss across recovery"
            )
    return None


def _inv_torn_never_acked(s: S) -> "str | None":
    """A torn record can only belong to a send that was never acked on
    the strength of that write (ack requires the complete step)."""
    torn = [sid for sid, done in s.log if not done]
    for name in torn:
        i = _send_index(name)
        if s.sends[i].phase == "acked" and _complete_count(s, name) == 0:
            return f"send {name} acked on a torn (incomplete) record"
    return None


def _live_all_acked(s: S) -> "str | None":
    problems = []
    for i, name in enumerate(SENDS):
        if s.sends[i].phase != "acked":
            problems.append(f"{name} never acked (phase={s.sends[i].phase})")
        elif _complete_count(s, name) == 0:
            problems.append(f"{name} acked but absent from the log")
    if not s.recovered:
        problems.append("tail recovery never ran")
    return "; ".join(problems) or None


# ---------------------------------------------------------------------------
# Model factory
# ---------------------------------------------------------------------------


def build(variant: str = "") -> Model:
    if variant not in ("",) + VARIANTS:
        raise ValueError(f"unknown broker-append variant {variant!r}")
    actions: list = []
    for name in SENDS:
        actions.append(_mk_send(name))
        actions.append(_mk_write(name, variant))
        actions.append(_mk_complete(name))
        actions.append(_mk_lose(name))
        actions.append(_mk_ack(name))
        actions.append(_mk_retry(name))
    actions.append(_mk_crash())
    actions.append(_mk_restart())
    actions.extend(_mk_recover(variant))
    return Model(
        name="broker-append",
        variant=variant,
        initial=_initial(),
        actions=tuple(actions),
        invariants=(
            ("no-duplicate-append", _inv_no_duplicate_append),
            ("no-acked-record-loss", _inv_no_acked_loss),
            ("torn-tail-never-acked", _inv_torn_never_acked),
        ),
        liveness=("every-send-acked-once", _live_all_acked),
    )
