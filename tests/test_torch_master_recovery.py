"""The killed-master drill on the port's processes, on the CPU
(``chip_smoke.run_master_kill_drill``, which phase 17 of
``chip_smoke.py`` runs on the card; the port of the JAX
package's ``bench_elastic.run_master_kill_drill`` and of
tests/test_master_recovery.py::test_master_restart_with_outage_riding_
client, which drills the same restart in one process).

A master CLI with two mnist process workers is SIGKILLed once three
training tasks are journaled done, and restarted from its journal with
``--num_workers 0`` on the same port.  Gates: every training task
completed exactly once and none failed, one restart journaled, the
second master exits 0 having launched no worker, the first master's two
worker processes alive when the first task completes after the restart,
a worker's trace dump written at its exit, and one connected trace
(the workers' ``rpc_retry``, the restarted master's
``journal.replayed``, a task completed after the restart).
"""

import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = 2048
RECORDS_PER_TASK = 32 * 4


def test_killed_master_is_ridden_out(tmp_path):
    from chip_smoke import run_master_kill_drill

    env = dict(os.environ, ELASTICDL_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    out = run_master_kill_drill(
        ["--model_zoo", "mnist", "--data_origin",
         "synthetic_mnist:%d" % RECORDS, "--batch_size", "32",
         "--num_minibatches_per_task", "4", "--num_epochs", "1"],
        env=env, cwd=str(tmp_path))
    logs = "\n".join(out["logs"])
    assert "error" not in out, logs
    assert out["tasks_done_at_kill"] >= 3
    assert out["tasks_completed"] == RECORDS // RECORDS_PER_TASK, logs
    assert out["tasks_failed"] == 0 and out["restarts"] == 1
    assert out["master2_rc"] == 0 and out["master2_launched"] == 0, logs
    assert sorted(out["worker_pids"]) == [0, 1]
    assert out["pids_alive_at_recovery"] == {0: True, 1: True}
    # As in the JAX drill: an idle orphan may ride its outage budget past
    # the job's end and be reaped, so one worker's dump is the gate.
    assert any(out["worker_dumps"].values()), logs
    assert out["trace_connected"], out["trace_events"]
    assert out["recovery_s"] is not None
