"""The port's supervisor policy (``supervise/policy.py``) against the JAX
package's, on the CPU.

The same sequences of ``ExitObservation``s (and operator resize requests)
go through a fresh JAX ``DecisionPolicy`` and a fresh port one built with
the same arguments, and every ``Decision`` must be the same tuple (action,
reason, delay, devices, share), with the same bookkeeping (restarts,
failure streak, ladder rung, pending resize) after each step. The
sequences cover every row of the exit table, the restart budget, the
backoff streak and its cap, the straggler ladder, the operator's resize
winning over mitigation, and the ladder resetting. Both policies raise
alike on bad arguments.
"""

import dataclasses

import pytest
from torch_threads import limit_threads

from simclr_pytorch_distributed_tpu.supervise import policy as jax_policy
from simclr_pytorch_distributed_tpu_torch.supervise import policy
from simclr_pytorch_distributed_tpu_torch.utils import guard, preempt

limit_threads()

# a mitigation preempt: the verdict named process 1 of 2 at 150 ms skew
STRAGGLER = dict(straggler_persistent=True, straggler_host=1, straggler_skew_s=0.15,
                 processes=2)


def ex(rc, **kw):
    return ("exit", rc, kw)


def sx(rc=75, **kw):
    return ex(rc, **{**STRAGGLER, **kw})


def resize(n):
    return ("resize", n, {})


# name -> (DecisionPolicy arguments, steps)
SEQUENCES = {
    # the exit table, one fresh policy per row
    **{f"row_{rc}": ({"max_restarts": 3}, [ex(rc)])
       for rc in (0, 75, 3, 1, 2, -9, -15, 7)},
    "stalled_kill": ({}, [ex(-9, stalled=True, stall_dumps=2), ex(0)]),
    "stalled_child_honored_sigterm": ({}, [ex(75, stalled=True, stall_dumps=1), ex(0)]),
    "health_outranks_a_full_budget": ({"max_restarts": 100}, [ex(75), ex(3)]),
    "budget_bounds_every_class": ({"max_restarts": 2, "backoff_base_s": 0.1},
                                  [ex(75), ex(-9), ex(1), ex(0)]),
    "zero_budget": ({"max_restarts": 0}, [ex(1), ex(75)]),
    "backoff_grows_and_caps": ({"max_restarts": 100, "backoff_base_s": 1.0,
                                "backoff_max_s": 5.0}, [ex(-9)] * 5),
    "clean_preempt_resets_the_streak": ({"max_restarts": 100},
                                        [ex(-9), ex(-9), ex(-9), ex(75), ex(-9), ex(2)]),
    "resize_upgrades_a_preempt": ({"max_restarts": 10},
                                  [resize(4), ex(75), ex(75), ex(0)]),
    "resize_upgrades_a_crash": ({"max_restarts": 10}, [resize(2), ex(-9), ex(0)]),
    "straggler_ladder": ({"max_restarts": 10}, [sx(), sx(), sx()]),
    "straggler_verdict_on_every_row": ({"max_restarts": 10},
                                       [sx(rc) for rc in (1, 2, -9, -15, 7, 75, 0)]),
    "straggler_health_abort": ({"max_restarts": 10}, [sx(3)]),
    "straggler_unknown_fleet_size": ({"max_restarts": 10}, [sx(), sx(processes=0)]),
    "straggler_host_unknown": ({"max_restarts": 10},
                               [sx(straggler_host=-1, straggler_skew_s=0.0)]),
    "ladder_resets_after_a_clean_preempt": ({"max_restarts": 10}, [sx(), ex(75), sx(), sx()]),
    "operator_resize_wins_over_mitigation": ({"max_restarts": 10}, [resize(4), sx(), sx()]),
    "budget_caps_the_ladder": ({"max_restarts": 1, "backoff_base_s": 0.1}, [ex(-9), sx()]),
    "stall_kill_outranks_a_verdict": ({"max_restarts": 10, "backoff_base_s": 1.0},
                                      [sx(stalled=True, stall_dumps=1), sx()]),
}


def state(p):
    return (p.restarts, p.failures, p.pending_resize, p.straggler_level)


def walk(module, kwargs, steps):
    p = module.DecisionPolicy(**kwargs)
    out = []
    for kind, value, kw in steps:
        if kind == "resize":
            p.request_resize(value)
            out.append(("resize", state(p)))
            continue
        d = p.decide(module.ExitObservation(returncode=value, **kw))
        out.append((dataclasses.astuple(d), state(p)))
    return out


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_decisions_equal_the_jax_policy(name):
    kwargs, steps = SEQUENCES[name]
    got = walk(policy, kwargs, steps)
    want = walk(jax_policy, kwargs, steps)
    assert got == want
    # the sequence exercised what its name says: no step raised, and the
    # actions are the policy's own strings
    actions = {d[0] for d, _ in got if d != "resize"}
    assert actions <= {policy.DONE, policy.RESTART, policy.RESTART_RESIZED,
                       policy.RESTART_REBALANCED, policy.BACKOFF_RESTART, policy.GIVE_UP}


def test_the_table_is_read_from_the_ports_exit_codes():
    assert (guard.EXIT_NONFINITE, guard.EXIT_FLUSH, guard.EXIT_HEALTH,
            preempt.EXIT_PREEMPTED) == (1, 2, 3, 75)
    for name in ("DONE", "RESTART", "RESTART_RESIZED", "RESTART_REBALANCED",
                 "BACKOFF_RESTART", "GIVE_UP", "SHUTDOWN", "REBALANCE_FACTOR"):
        assert getattr(policy, name) == getattr(jax_policy, name), name


@pytest.mark.parametrize("build", [
    lambda m: m.DecisionPolicy(max_restarts=-1),
    lambda m: m.DecisionPolicy(backoff_base_s=0.0),
    lambda m: m.DecisionPolicy(backoff_base_s=2.0, backoff_max_s=1.0),
    lambda m: m.DecisionPolicy().request_resize(0),
], ids=["negative_budget", "zero_backoff", "cap_below_base", "zero_resize"])
def test_bad_arguments_raise_alike(build):
    with pytest.raises(ValueError) as want:
        build(jax_policy)
    with pytest.raises(ValueError) as got:
        build(policy)
    assert str(got.value) == str(want.value)
