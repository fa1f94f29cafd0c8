"""Declarative SLO watchdog — objectives as first-class objects.

Before this module the system had exactly one SLO and it was
hand-rolled: the aggregation tier compared publish freshness against
a threshold and bumped a counter.  Every other objective an operator
actually cares about — serving p99, per-job steps/s, straggler count —
had to be reconstructed from raw gauges by an external alerting stack.
This module evaluates them IN PROCESS, on the same histogram
snapshots the /metrics surfaces render, and makes a breach three
things at once:

 - a **flight-recorder event** (``slo.breach`` in the span taxonomy,
   docs/observability.md) — so a breach is in the crash dump and in
   ``/tracez``, causally placed among the elastic events around it;
 - an **HTTP surface**: every status server serves ``GET /alertz``
   with the live rule table (value, threshold, ok, breach episodes);
 - a **/metrics series pair**: ``elasticdl_slo_ok{rule=}`` and
   ``elasticdl_slo_breach_total{rule=}`` via the shared renderer
   (utils/prom.py), one format across tiers.

Rules are declarative strings over named sources::

    wd = SloWatchdog()
    wd.bind_timing(timing)                   # pXX()/mean() phases
    wd.add_source("freshness", lambda: agg.freshness_seconds)
    wd.add_rule("p99(batcher.queue_wait) < 0.050")
    wd.add_rule("value(freshness) < 10", name="agg_freshness")
    wd.add_rule("value(steps_per_sec) > 5", name="job_throughput")

``pNN(name)``/``mean(name)`` read a histogram snapshot (a bound
Timing phase, or an explicit source returning a snapshot dict);
``value(name)`` reads a float source.  A source returning ``None``
means "no data yet" — never a breach.  ``breach_total`` counts breach
EPISODES (ok->breach transitions), so it is independent of how often
anything polls; the per-evaluation verdict is returned to callers
that need miss counts (the aggregation tier's ``slo_misses``).

Processes can arm extra rules from the environment without CLI
plumbing: ``ELASTICDL_SLO_SPEC="rule;rule"`` is parsed by
``arm_from_env()`` at every entrypoint that owns a watchdog.
"""

import json
import os
import re
import threading
import time

from elasticdl_tpu_torch.utils import hist as hist_mod
from elasticdl_tpu_torch.utils import tracing
from elasticdl_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

ENV_SLO_SPEC = "ELASTICDL_SLO_SPEC"

_RULE_RE = re.compile(
    r"^\s*(?P<fn>p\d{1,2}(?:\.\d+)?|mean|value)"
    r"\((?P<source>[\w./:-]+)\)\s*"
    r"(?P<op><=|>=|<|>)\s*"
    r"(?P<threshold>[-+]?[0-9.]+(?:[eE][-+]?\d+)?)\s*$"
)

_OPS = {
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
}


class SloRule:
    """One parsed objective: ``fn(source) op threshold``."""

    __slots__ = ("name", "fn", "source", "op", "threshold",
                 "description", "spec")

    def __init__(self, spec, name=None, description=""):
        m = _RULE_RE.match(spec)
        if not m:
            raise ValueError(
                "bad SLO rule %r (want e.g. 'p99(phase) < 0.05', "
                "'value(freshness) < 10')" % spec)
        self.spec = spec.strip()
        self.fn = m.group("fn")
        self.source = m.group("source")
        self.op = m.group("op")
        self.threshold = float(m.group("threshold"))
        self.name = name or "%s_%s" % (
            self.fn, self.source.replace(".", "_").replace("/", "_"))
        self.description = description

    def value_from(self, raw):
        """Raw source output -> the compared float (or None)."""
        if raw is None:
            return None
        if self.fn == "value":
            return float(raw)
        if not isinstance(raw, dict):
            return None
        if self.fn == "mean":
            return hist_mod.mean(raw)
        q = float(self.fn[1:]) / 100.0
        return hist_mod.quantile(raw, q)


class SloWatchdog:
    """Evaluates a rule table against named sources; tracks breach
    episodes; renders the /alertz payload.  Evaluation is cheap (a few
    snapshot reads) and runs wherever the owner already ticks — plus
    on every /alertz read, so the surface is never stale."""

    def __init__(self, tracer=None):
        self._lock = threading.Lock()
        self._sources = {}
        self._timing = None
        self._rules = {}
        self._state = {}
        self._tracer = tracer

    # -- construction --------------------------------------------------

    def bind_timing(self, timing):
        """Default histogram namespace for pXX()/mean() rules: any
        phase of this Timing resolves without an explicit source."""
        with self._lock:
            self._timing = timing
        return self

    def add_source(self, name, fn):
        """``fn`` is a zero-arg callable returning a float (value
        rules) or a hist snapshot dict (pXX/mean rules), or None for
        "no data"."""
        with self._lock:
            self._sources[name] = fn
        return self

    def add_rule(self, spec, name=None, description=""):
        rule = SloRule(spec, name=name, description=description)
        with self._lock:
            self._rules[rule.name] = rule
            self._state.setdefault(rule.name, {
                "ok": True, "breach_total": 0, "last_value": None,
                "last_breach_ts": None,
            })
        return rule

    def arm_from_env(self, env=None):
        """Parse ``ELASTICDL_SLO_SPEC`` (';'-separated rule specs,
        each optionally ``name=spec``) into the rule table; bad specs
        are logged and skipped — an env typo must not kill a tier."""
        spec = (env if env is not None
                else os.environ.get(ENV_SLO_SPEC, ""))
        for piece in spec.split(";"):
            piece = piece.strip()
            if not piece:
                continue
            name = None
            if "=" in piece.split("(")[0]:
                name, piece = piece.split("=", 1)
                name = name.strip()
            try:
                self.add_rule(piece, name=name)
            except ValueError as e:
                logger.warning("ignoring bad SLO rule: %s", e)
        return self

    @property
    def rule_count(self):
        with self._lock:
            return len(self._rules)

    # -- evaluation ----------------------------------------------------

    def _resolve(self, rule):
        with self._lock:
            fn = self._sources.get(rule.source)
            timing = self._timing
        if fn is not None:
            return fn()
        if timing is not None and rule.fn != "value":
            return timing.hist_snapshot(rule.source)
        return None

    def evaluate(self, now=None):
        """One pass over every rule; returns {name: {"ok", "value",
        "breached_now"}}.  A breach EPISODE (ok->breach transition)
        emits the ``slo.breach`` flight-recorder event and bumps the
        episode counter; ``breached_now`` is the per-evaluation
        verdict for callers counting misses."""
        now = time.time() if now is None else now
        with self._lock:
            rules = list(self._rules.values())
        results = {}
        for rule in rules:
            try:
                value = rule.value_from(self._resolve(rule))
            except Exception as e:  # noqa: BLE001 — a broken source
                # must not take the watchdog (or its caller) down
                logger.warning("SLO source %r failed: %s",
                               rule.source, e)
                value = None
            breached = (value is not None
                        and not _OPS[rule.op](value, rule.threshold))
            episode = False
            with self._lock:
                st = self._state[rule.name]
                st["last_value"] = value
                if breached and st["ok"]:
                    episode = True
                    st["breach_total"] += 1
                    st["last_breach_ts"] = now
                st["ok"] = not breached
            if episode:
                # Event outside the lock (recorder has its own); the
                # breach lands in the flight recorder + /tracez,
                # causally among the elastic events around it.
                tracer = self._tracer or tracing.default_tracer()
                tracer.event("slo.breach", rule=rule.name,
                             spec=rule.spec, value=value,
                             threshold=rule.threshold)
                logger.warning("SLO breach: %s (value %s vs %s %s)",
                               rule.spec, value, rule.op,
                               rule.threshold)
            results[rule.name] = {"ok": not breached, "value": value,
                                  "breached_now": breached}
        return results

    def payload(self, evaluate=True):
        """The /alertz body (and the "slo" status-dict section the
        /metrics renderers consume via prom._slo_gauges)."""
        if evaluate:
            self.evaluate()
        with self._lock:
            rules = {
                name: {
                    "spec": rule.spec,
                    "description": rule.description,
                    "ok": self._state[name]["ok"],
                    "value": self._state[name]["last_value"],
                    "threshold": rule.threshold,
                    "op": rule.op,
                    "breach_total": self._state[name]["breach_total"],
                    "last_breach_ts":
                        self._state[name]["last_breach_ts"],
                }
                for name, rule in self._rules.items()
            }
        return {
            "rules": rules,
            "breaching": sorted(n for n, r in rules.items()
                                if not r["ok"]),
        }


# Module-level default watchdog: the process's one rule table (the
# tracing._TRACER idiom).  Tests build private instances.
_WATCHDOG = SloWatchdog()


def default_watchdog():
    return _WATCHDOG


def slo_section():
    """The "slo" section status collectors attach (None when no rules
    are armed, so payload shapes without SLOs are unchanged)."""
    if _WATCHDOG.rule_count == 0:
        return None
    return _WATCHDOG.payload()


def alertz_body(watchdog=None):
    """Shared /alertz HTTP responder body (every status surface)."""
    wd = watchdog or _WATCHDOG
    return json.dumps(wd.payload())


def is_alertz_path(path):
    return path.split("?", 1)[0] == "/alertz"
