"""The port's replica-fleet supervision (``supervise/replica.py``,
``supervise/replica_fleet.py``) against the JAX package's.

``classify`` and ``ReplicaPolicy.decide`` are pure: over the whole
condition grid of ``tests/test_replica_fleet.py`` (alive, scraped, within
the start-up grace, work pending, completion age past the stall threshold,
occupancy high, queue high, quiescent) and over sequences of decide calls
(restart budgets, unscrape strikes, give-ups, scaling), the port's answers
equal JAX's. The supervisor loop runs on fake Popen, scraper and clock in
both packages (spawn to the floor, restart on the same port, give-up and
backfill, scale up and drain), with the same decisions. No process starts.
"""

import itertools
import sys
import types

import pytest

from simclr_pytorch_distributed_tpu.supervise import replica as jax_replica
from simclr_pytorch_distributed_tpu.supervise import replica_fleet as jax_replica_fleet
from simclr_pytorch_distributed_tpu_torch.supervise import replica as port_replica
from simclr_pytorch_distributed_tpu_torch.supervise import replica_fleet as port_replica_fleet
from torch_threads import limit_threads

limit_threads()

PACKAGES = {
    "jax": types.SimpleNamespace(replica=jax_replica, fleet=jax_replica_fleet),
    "port": types.SimpleNamespace(replica=port_replica, fleet=port_replica_fleet),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def gauges(r, queued=0.0, inflight=0.0, age=0.0, occ=0.0):
    return {r.QUEUE_GAUGE: queued, r.INFLIGHT_GAUGE: inflight, r.AGE_GAUGE: age,
            r.OCC_GAUGE: occ}


def grid(r):
    """Every combination of the table's conditions as ``(observation,
    kwargs)``, for module ``r``, in one order."""
    params = dict(startup_grace_s=60.0, stall_age_s=30.0, occ_hi=0.9, queue_hi=64.0,
                  occ_lo=0.1)
    for alive, scraped, young, pending, stale, occ_hi, q_hi, quiet in itertools.product(
            [False, True], repeat=8):
        m = gauges(r, queued=80.0 if q_hi else (1.0 if pending else 0.0),
                   inflight=1.0 if pending else 0.0, age=99.0 if stale else 1.0,
                   occ=0.95 if occ_hi else (0.05 if quiet else 0.5))
        yield r.ReplicaObservation(0, alive, m if scraped else None,
                                   5.0 if young else 120.0), params


def test_classify_equals_jax_over_the_whole_grid():
    got = {name: [pkg.replica.classify(o, **kw) for o, kw in grid(pkg.replica)]
           for name, pkg in PACKAGES.items()}
    assert got["port"] == got["jax"]
    assert len(got["port"]) == 256 and set(got["port"]) == {
        "dead", "starting", "unscrapeable", "stalled", "saturated", "idle", "busy"}


def test_classify_exhaustive_over_the_condition_grid(pkg):
    r = pkg.replica
    P = dict(startup_grace_s=60.0, stall_age_s=30.0, occ_hi=0.9, queue_hi=64.0, occ_lo=0.1)
    for alive, scraped in itertools.product([False, True], repeat=2):
        for young, pending, stale, occ_hi, q_hi in itertools.product([False, True], repeat=5):
            m = gauges(r, queued=80.0 if q_hi else (1.0 if pending else 0.0),
                       inflight=1.0 if pending else 0.0, age=99.0 if stale else 1.0,
                       occ=0.95 if occ_hi else 0.5)
            o = r.ReplicaObservation(0, alive, m if scraped else None,
                                     5.0 if young else 120.0)
            got = r.classify(o, **P)
            if not alive:
                assert got == r.DEAD
            elif not scraped:
                assert got == (r.STARTING if young else r.UNSCRAPEABLE)
            elif (pending or q_hi) and stale:
                assert got == r.STALLED
            elif occ_hi or q_hi:
                assert got == r.SATURATED
            else:
                assert got == r.BUSY


def test_classify_idle_and_thresholds(pkg):
    r = pkg.replica

    def obs(metrics=None, age_s=0.0):
        return r.ReplicaObservation(0, True, metrics, age_s)

    assert r.classify(obs(gauges(r))) == r.IDLE
    assert r.classify(obs(gauges(r, occ=0.05))) == r.IDLE
    assert r.classify(obs(gauges(r, queued=1))) == r.BUSY
    assert r.classify(obs(gauges(r, inflight=1))) == r.BUSY
    assert r.classify(obs(gauges(r, occ=0.5))) == r.BUSY
    assert r.classify(obs(gauges(r, occ=0.9))) == r.SATURATED
    assert r.classify(obs(gauges(r, queued=64))) == r.SATURATED
    assert r.classify(obs(gauges(r, occ=0.1))) == r.IDLE
    assert r.classify(obs(None, age_s=60.0)) == r.STARTING
    assert r.classify(obs(gauges(r, queued=1, age=30.0))) == r.BUSY


def test_policy_validation(pkg):
    for args, kw in (((0, 4), {}), ((3, 2), {}), ((1, 2), {"unscrape_strikes": 0}),
                     ((1, 2), {"max_restarts": -1})):
        with pytest.raises(ValueError):
            pkg.replica.ReplicaPolicy(*args, **kw)


def _decide_trace(r, seed):
    """A seeded walk of decide calls over a fleet of up to 4 replicas, each
    observation drawn from the grid's conditions; returns every decision."""
    import random

    rnd = random.Random(seed)
    policy = r.ReplicaPolicy(rnd.choice([1, 2]), rnd.choice([2, 3, 4]), max_restarts=2,
                             unscrape_strikes=2)
    conditions = [o for o, _ in grid(r)]
    trace = []
    for _ in range(60):
        n = rnd.randint(1, 4)
        picked = [rnd.choice(conditions) for _ in range(n)]
        observations = [r.ReplicaObservation(i, o.alive, o.metrics, o.age_s)
                        for i, o in enumerate(picked)]
        trace.append([(d.action, d.replica, d.reason) for d in policy.decide(observations)])
    return trace, sorted(policy.given_up), dict(policy.restarts)


@pytest.mark.parametrize("seed", range(8))
def test_decide_equals_jax_over_seeded_fleets(seed):
    assert _decide_trace(port_replica, seed) == _decide_trace(jax_replica, seed)


def test_dead_replica_restarts_until_budget_then_gives_up(pkg):
    r = pkg.replica
    p = r.ReplicaPolicy(1, 4, max_restarts=2)
    busy = r.ReplicaObservation(1, True, gauges(r, queued=1, inflight=1, age=1, occ=0.5))
    dead = r.ReplicaObservation(0, False)
    for expect in (1, 2):
        d = p.decide([dead, busy])
        assert [x.action for x in d] == [r.RESTART]
        assert d[0].replica == 0 and f"{expect}/2" in d[0].reason
    assert [x.action for x in p.decide([dead, busy])] == [r.GIVE_UP]
    assert p.given_up == {0}
    assert p.decide([dead, busy]) == []


def test_unscrapeable_needs_consecutive_strikes_and_recovery_resets(pkg):
    r = pkg.replica
    p = r.ReplicaPolicy(1, 4, unscrape_strikes=3)
    gone = r.ReplicaObservation(0, True, None, 120.0)
    ok = r.ReplicaObservation(0, True, gauges(r, queued=1, inflight=1, age=1, occ=0.5))
    for o in (gone, gone, ok, gone, gone):
        assert p.decide([o]) == []
    assert [x.action for x in p.decide([gone])] == [r.RESTART]


def test_scaling_rows(pkg):
    r = pkg.replica
    busy = gauges(r, queued=1, inflight=1, age=1, occ=0.5)
    d = r.ReplicaPolicy(2, 4).decide([r.ReplicaObservation(0, True, busy)])
    assert [x.action for x in d] == [r.SPAWN] and d[0].replica == -1
    p = r.ReplicaPolicy(1, 2)
    hot = r.ReplicaObservation(0, True, gauges(r, occ=0.95))
    assert [x.action for x in p.decide([hot])] == [r.SPAWN]
    assert p.decide([hot, r.ReplicaObservation(1, True, gauges(r, occ=0.95))]) == []
    idle = [r.ReplicaObservation(i, True, gauges(r)) for i in (0, 2)]
    d = r.ReplicaPolicy(1, 4).decide([idle[0], r.ReplicaObservation(1, True, busy), idle[1]])
    assert [(x.action, x.replica) for x in d] == [(r.DRAIN, 2)]
    d = r.ReplicaPolicy(3, 4, max_restarts=0).decide(
        [r.ReplicaObservation(0, False), r.ReplicaObservation(1, True, busy)])
    assert [x.action for x in d] == [r.GIVE_UP, r.SPAWN]


# ------------------------------------------------------- supervisor (fakes)


class FakeProc:
    def __init__(self, cmd):
        self.cmd = cmd
        self.returncode = None

    def poll(self):
        return self.returncode

    def wait(self):
        return self.returncode if self.returncode is not None else 0

    def send_signal(self, _sig):
        self.returncode = -15

    def kill(self):
        self.returncode = -9


class FakeScraper:
    def __init__(self, port):
        self.port = port
        self.metrics = None

    def scrape(self):
        return self.metrics


def harness(pkg, policy, **cfg_kwargs):
    state = {"t": 0.0, "procs": [], "scrapers": {}}
    ports = itertools.count(9000)

    def popen(cmd, env=None):
        p = FakeProc(cmd)
        state["procs"].append(p)
        return p

    def fake_sleep(seconds):
        state["t"] += seconds

    cfg = pkg.fleet.ReplicaFleetConfig(command=["serve", "--port", "{port}"], grace_s=1.0,
                                       **cfg_kwargs)
    sup = pkg.fleet.ReplicaFleetSupervisor(
        cfg, policy, popen=popen, clock=lambda: state["t"], sleep=fake_sleep,
        free_port=lambda: next(ports),
        scraper_factory=lambda port: state["scrapers"].setdefault(port, FakeScraper(port)))
    return sup, state


def busy_m(r):
    return gauges(r, queued=1, inflight=1, age=1, occ=0.5)


def test_supervisor_spawns_to_floor_and_substitutes_the_port(pkg):
    r = pkg.replica
    sup, state = harness(pkg, r.ReplicaPolicy(2, 3))
    assert [d["action"] for d in sup.step()] == [r.SPAWN]
    assert [d["action"] for d in sup.step()] == [r.SPAWN]
    assert state["procs"][0].cmd == ["serve", "--port", "9000"]
    assert state["procs"][1].cmd == ["serve", "--port", "9001"]
    for s in state["scrapers"].values():
        s.metrics = busy_m(r)
    assert sup.step() == []
    sup.stop_all()
    assert sup.replicas() == {}
    assert all(p.returncode is not None for p in state["procs"])


def test_supervisor_restarts_killed_replica_on_the_same_port(pkg):
    r = pkg.replica
    sup, state = harness(pkg, r.ReplicaPolicy(2, 3, max_restarts=1))
    sup.step()
    sup.step()
    for s in state["scrapers"].values():
        s.metrics = busy_m(r)
    state["procs"][0].returncode = -9
    d = sup.step()
    assert [x["action"] for x in d] == [r.RESTART]
    assert d[0]["replica"] == 0 and d[0]["port"] == 9000 and d[0]["old_returncode"] == -9
    assert sup.replicas()[0] == {"port": 9000, "pid": None, "alive": True, "restarts": 1}


def test_supervisor_budget_exhaustion_gives_up_then_backfills(pkg):
    r = pkg.replica
    sup, state = harness(pkg, r.ReplicaPolicy(2, 3, max_restarts=0))
    sup.step()
    sup.step()
    for s in state["scrapers"].values():
        s.metrics = busy_m(r)
    state["procs"][0].returncode = -9
    assert [x["action"] for x in sup.step()] == [r.GIVE_UP, r.SPAWN]
    assert sup.gave_up() == [0]
    assert sorted(sup.replicas()) == [1, 2]


def test_supervisor_scales_up_on_saturation_and_drains_idle(pkg):
    r = pkg.replica
    sup, state = harness(pkg, r.ReplicaPolicy(1, 2))
    sup.step()
    state["scrapers"][9000].metrics = gauges(r, occ=0.95)
    assert [x["action"] for x in sup.step()] == [r.SPAWN]
    state["scrapers"][9000].metrics = busy_m(r)
    state["scrapers"][9001].metrics = gauges(r)
    assert [(x["action"], x["replica"]) for x in sup.step()] == [(r.DRAIN, 1)]
    assert sorted(sup.replicas()) == [0]


def test_supervisor_run_until_predicate(pkg):
    r = pkg.replica
    sup, _ = harness(pkg, r.ReplicaPolicy(1, 2))
    sup.run(until=lambda: len(sup.replicas()) >= 1)
    assert len(sup.replicas()) == 1
    assert [d["action"] for d in sup.decisions()] == [r.SPAWN]


def test_the_two_supervisors_decide_alike():
    """One scripted scenario on both loops: the same applied decisions."""
    records = {}
    for name, pkg in PACKAGES.items():
        r = pkg.replica
        sup, state = harness(pkg, r.ReplicaPolicy(2, 3, max_restarts=1))
        script = [
            lambda: None,
            lambda: None,
            lambda: [setattr(s, "metrics", busy_m(r)) for s in state["scrapers"].values()],
            lambda: setattr(state["procs"][0], "returncode", -9),
            lambda: setattr(state["scrapers"][9001], "metrics", gauges(r, occ=0.95)),
            lambda: setattr(state["procs"][-1], "returncode", -9),
            lambda: [setattr(s, "metrics", gauges(r)) for s in state["scrapers"].values()],
        ]
        out = []
        for act in script:
            act()
            out.append(sup.step())
        records[name] = (out, sup.replicas(), sup.gave_up())
        sup.stop_all()
    assert records["port"] == records["jax"]


def test_the_default_replica_is_the_ports_fleet_frontend():
    cfg = port_replica_fleet.ReplicaFleetConfig()
    assert cfg.command == [sys.executable, "-m",
                           "simclr_pytorch_distributed_tpu_torch.serve.fleet", "--port",
                           "{port}"]
    assert port_replica_fleet.fleet_command("--device", "cpu")[-2:] == ["--device", "cpu"]
