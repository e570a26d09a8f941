"""Worker process entry point (the port of `ray_tpu/core/worker_main.py`).

Reference equivalent: `python/ray/_private/workers/default_worker.py` +
`Worker.main_loop` (`_private/worker.py:799`): construct the core-worker
runtime in worker mode, register with the raylet, and serve task pushes
until told to exit.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--raylet", required=True)
    parser.add_argument("--gcs", required=True)
    parser.add_argument("--worker-id", required=True)
    parser.add_argument("--node-id", required=True)
    args = parser.parse_args()

    logging.basicConfig(
        level=logging.INFO,
        format=f"[worker {args.worker_id[:8]}] %(message)s")

    # SIGUSR1 dumps all thread stacks to stderr (the worker log file):
    # the debugging affordance for "worker stuck in what?" (reference:
    # ray stack / py-spy integration).
    import faulthandler

    faulthandler.register(signal.SIGUSR1, all_threads=True, chain=False)

    # No platform pin: the raylet started this worker with
    # CUDA_VISIBLE_DEVICES="", and a GPU lease sets its ids before any
    # user code runs (cluster_runtime._apply_visible_chips). Nothing here
    # imports torch.
    from ray_tpu_torch.core.cluster_runtime import ClusterRuntime
    from ray_tpu_torch.core.worker import set_runtime

    runtime = ClusterRuntime(
        gcs_address=args.gcs, raylet_address=args.raylet, mode="worker",
        node_id=args.node_id, worker_id=args.worker_id)
    set_runtime(runtime)

    ok = runtime._loop.run(runtime._raylet.call(
        "register_worker", worker_id=args.worker_id,
        address=runtime.address))
    if not ok:
        logging.error("raylet rejected registration; exiting")
        sys.exit(1)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    # Watchdog: a worker must not outlive its raylet (reference: workers
    # exit on raylet socket EOF, node_manager disconnect handling).
    while not stop.wait(timeout=1.0):
        if not runtime._raylet.connected:
            logging.info("raylet connection lost; exiting")
            break
    # Graceful shutdown can wedge on non-daemon task threads (a user task
    # blocked in get() against a dying cluster); the process must still
    # exit promptly or it orphans past the raylet's kill window. Arm a
    # hard-exit backstop, attempt the clean path, then force the issue.
    import os

    killer = threading.Timer(3.0, lambda: os._exit(1))
    killer.daemon = True
    killer.start()
    try:
        runtime.shutdown()
    except BaseException:
        logging.exception("shutdown failed")
        os._exit(1)
    os._exit(0)


if __name__ == "__main__":
    main()
