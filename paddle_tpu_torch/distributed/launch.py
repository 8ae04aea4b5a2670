"""Process launcher — `python -m paddle_tpu_torch.distributed.launch train.py ...`
(counterpart of ``paddle_tpu/distributed/launch.py``, a copy).

Parity: python/paddle/distributed/launch.py:147,283 (start_procs: one process
per device with the PADDLE_* env contract, log redirection).

As the reference does on GPUs, the port runs one process per rank: a
worker's ``fleet.init()`` reads the PADDLE_* env, sets its card
(``FLAGS_selected_gpus``, else its rank modulo the cards) and joins the
``torch.distributed`` world through rank 0's store at the endpoint list's
head (the gen_nccl_id replacement).  ``--backend`` names the process
group's backend: ``auto`` is NCCL on a card and gloo on the CPU; ``gloo``
runs ranks that share one card (NCCL refuses two ranks on one device).
The workers are started with subprocess (a fresh interpreter each, never a
fork of a process that holds CUDA state), and the elastic retries are the
reference's.
"""

import argparse
import os
import signal
import subprocess
import sys
import time

from ..ft import PREEMPTED_RC

__all__ = ["launch", "start_procs", "PREEMPTED_RC"]


def _parse_args(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--cluster_node_ips", type=str, default="127.0.0.1",
                   help="comma-separated host ips")
    p.add_argument("--node_ip", type=str, default="127.0.0.1")
    p.add_argument("--started_port", type=int, default=6170)
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="processes on this node (one per card)")
    p.add_argument("--backend", choices=("auto", "nccl", "gloo"),
                   default="auto",
                   help="the process group's backend, exported to the "
                        "workers as PADDLE_DISTRI_BACKEND: auto is NCCL on "
                        "a card and gloo on the CPU; gloo runs ranks that "
                        "share one card")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--elastic_retries", type=int, default=0,
                   help="restart a crashed worker up to N times.  The budget "
                        "is GLOBAL across the job, not per worker: a crash "
                        "restarts EVERY worker (collective jobs wedge "
                        "otherwise).  A restarted worker starts its script "
                        "again; the port has no checkpoint to resume from "
                        "until ROADMAP item 5-D.  --elastic_reset_secs "
                        "refills the budget after a healthy stretch; a "
                        "worker that exits with rc=%d (ft.PREEMPTED_RC) is "
                        "restarted without burning it." % PREEMPTED_RC)
    p.add_argument("--elastic_reset_secs", type=float, default=600.0,
                   help="refill the elastic retry budget after this many "
                        "seconds without a crash (0 disables: the budget "
                        "then covers the job's whole lifetime)")
    p.add_argument("--term_grace_secs", type=float, default=60.0,
                   help="on a fleet restart/shutdown, how long a worker "
                        "gets to act on SIGTERM before it is SIGKILLed, so "
                        "a restart is never hostage to a wedged worker")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def start_procs(args):
    """Parity: launch.py:147 start_procs."""
    node_ips = args.cluster_node_ips.split(",")
    node_id = node_ips.index(args.node_ip)
    nproc = args.nproc_per_node
    world = ["%s:%d" % (ip, args.started_port + i)
             for ip in node_ips for i in range(nproc)]

    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)

    log_handles = {}

    def spawn(local_rank, attempt=0):
        rank = node_id * nproc + local_rank
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(len(world)),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(world),
            "PADDLE_CURRENT_ENDPOINT": world[rank],
            "PADDLE_RESTART_ATTEMPT": str(attempt),
        })
        if args.backend != "auto":
            env["PADDLE_DISTRI_BACKEND"] = args.backend
        cmd = [sys.executable, "-u", args.training_script] + args.training_script_args
        if args.log_dir:
            old = log_handles.pop(rank, None)
            if old is not None:
                old.close()
            # fresh launch truncates; elastic respawn appends to keep the
            # crash context
            logf = open(os.path.join(args.log_dir, "worker.%d.log" % rank),
                        "w" if attempt == 0 else "a")
            log_handles[rank] = logf
            return subprocess.Popen(cmd, env=env, stdout=logf, stderr=logf)
        return subprocess.Popen(cmd, env=env)

    procs = [spawn(i) for i in range(nproc)]
    retries = 0
    shutting_down = [False]

    def stop_workers(targets):
        """SIGTERM the targets, grant --term_grace_secs, then SIGKILL
        stragglers.  Every restart and shutdown path funnels here so no
        wedged worker can hang the job."""
        for p in targets:
            if p.poll() is None:
                p.terminate()
        deadline = time.monotonic() + max(args.term_grace_secs, 0.0)
        for p in targets:
            while p.poll() is None and time.monotonic() < deadline:
                time.sleep(0.1)
            if p.poll() is None:
                sys.stderr.write(
                    "[launch] worker pid %d ignored SIGTERM for %.0fs; "
                    "killing\n" % (p.pid, args.term_grace_secs))
                p.kill()
            p.wait()

    def _terminate(signum, frame):
        shutting_down[0] = True
        for p in procs:
            p.terminate()

    signal.signal(signal.SIGTERM, _terminate)
    rc = 0
    try:
        if args.elastic_retries > 0:
            # Elastic mode (restart elasticity, SURVEY.md §5):
            # any crashed worker triggers a WHOLE-JOB restart — in a
            # collective job the surviving ranks are wedged in collectives
            # and a lone rejoiner cannot re-initialize against the running
            # coordinator, so all workers stop and respawn, each resuming
            # from the start of its script.  Clean exits (rc=0) are final.
            pending = set(range(nproc))
            completed = set()          # clean exits are final, never respawn
            attempt = 0                # spawn-generation counter (env +
                                       # log-append marker; monotonic even
                                       # when a restart was budget-free)
            last_crash = time.monotonic()
            while pending and not shutting_down[0]:
                # healthy-run budget refill: a long clean stretch proves the
                # earlier crashes were environmental (preemption storm, fs
                # blip), so the job earns its retry budget back instead of
                # carrying week-old strikes to its grave
                if retries and args.elastic_reset_secs > 0 and \
                        time.monotonic() - last_crash > args.elastic_reset_secs:
                    sys.stderr.write(
                        "[launch] %.0fs without a crash: elastic retry "
                        "budget reset (%d/%d used -> 0/%d)\n"
                        % (args.elastic_reset_secs, retries,
                           args.elastic_retries, args.elastic_retries))
                    retries = 0
                crashed = None
                for i in sorted(pending):
                    r = procs[i].poll()
                    if r is None:
                        continue
                    if r == 0:
                        pending.discard(i)
                        completed.add(i)
                    else:
                        crashed = (i, r)
                        break
                if crashed is not None and not shutting_down[0]:
                    i, r = crashed
                    last_crash = time.monotonic()
                    # a preemption exit (rc PREEMPTED_RC) is routine on
                    # preemptible pools: restart it for free, the budget is
                    # for crashes
                    preempted = (r == PREEMPTED_RC)
                    if preempted or retries < args.elastic_retries:
                        if not preempted:
                            retries += 1
                        attempt += 1
                        restart = [j for j in range(nproc)
                                   if j not in completed]
                        if preempted:
                            sys.stderr.write(
                                "[launch] worker %d preempted (rc=%d); "
                                "free elastic restart, budget kept %d/%d "
                                "(workers %s)\n"
                                % (i, r, retries, args.elastic_retries,
                                   restart))
                        else:
                            sys.stderr.write(
                                "[launch] worker %d exited rc=%d; elastic "
                                "restart %d/%d (workers %s)\n"
                                % (i, r, retries, args.elastic_retries,
                                   restart))
                        stop_workers([procs[j] for j in restart])
                        for j in restart:
                            procs[j] = spawn(j, attempt=attempt)
                        pending = set(restart)
                    else:
                        # out of retries: reap the survivors too — a
                        # collective job's remaining ranks are wedged
                        rc = rc or r
                        stop_workers(procs)
                        break
                time.sleep(0.2)
            if shutting_down[0]:
                # re-signal: a respawn racing the SIGTERM handler may have
                # left fresh workers unsignalled
                stop_workers(procs)
                rc = rc or 1
        else:
            for p in procs:
                p.wait()
                rc = rc or p.returncode
    except KeyboardInterrupt:
        for p in procs:
            p.terminate()
        rc = 1
    finally:
        for f in log_handles.values():
            f.close()
    return rc


def launch(argv=None):
    args = _parse_args(argv)
    return start_procs(args)


if __name__ == "__main__":
    sys.exit(launch())
