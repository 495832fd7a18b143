"""A persistent queue of eval commands fanned out over the cards.

Counterpart of the repository's ``parallelize_evals.py``: one worker
thread per card slot, each job pinned to its slot through
``CUDA_VISIBLE_DEVICES`` (``--device_env``), per-slot logs, and a journal
in ``--log_dir``: ``queue.json`` (jobs not started) and ``completed.json``
(jobs done, failed, and running). ``--resume`` takes the commands from the
journal instead, the running ones first (an interrupted sweep picks up
where it stopped). Ctrl-C terminates the running jobs.

Jobs come from a command file (one shell command per line) or from the
product of cache configs x tasks x cache sizes, each a
``python -m cold_compress_tpu_torch.eval`` command.

    python -m cold_compress_tpu_torch.parallelize_evals --num_slots 4 \\
        --cache_configs heavy_hitter l2 --tasks rulerniah --cache_sizes 0.25 0.5
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from queue import Empty, Queue
from typing import List, Optional, Sequence


class JobQueue:
    def __init__(self, commands, n_slots: int, log_dir: Path, device_env: str):
        self.queue = Queue()
        for cmd in commands:
            self.queue.put(cmd)
        self.n_slots = n_slots
        self.log_dir = log_dir
        self.device_env = device_env
        self.completed = []
        self.failed = []
        self.running = {}  # slot: command
        self.procs = {}
        self.lock = threading.Lock()
        log_dir.mkdir(parents=True, exist_ok=True)
        self._journal()

    def _journal(self):
        (self.log_dir / "queue.json").write_text(json.dumps(list(self.queue.queue), indent=2))
        (self.log_dir / "completed.json").write_text(json.dumps(
            {"completed": self.completed, "failed": self.failed,
             "running": [self.running[s] for s in sorted(self.running)]}, indent=2))

    def worker(self, slot: int):
        log_fn = self.log_dir / f"slot_{slot}.log"
        while True:
            with self.lock:
                try:
                    cmd = self.queue.get_nowait()
                except Empty:
                    return
                self.running[slot] = cmd
                self._journal()
            env = dict(os.environ)
            env[self.device_env] = str(slot)
            print(f"[slot {slot}] {cmd}")
            with open(log_fn, "a") as log:
                log.write(f"\n==== {time.ctime()} :: {cmd}\n")
                log.flush()
                proc = subprocess.Popen(cmd, shell=True, stdout=log, stderr=log, env=env)
                with self.lock:
                    self.procs[slot] = proc
                code = proc.wait()
            with self.lock:
                self.procs.pop(slot, None)
                self.running.pop(slot, None)
                (self.completed if code == 0 else self.failed).append(
                    {"cmd": cmd, "exit_code": code, "slot": slot})
                self._journal()
            self.queue.task_done()

    def run(self):
        threads = [threading.Thread(target=self.worker, args=(slot,), daemon=True)
                   for slot in range(self.n_slots)]
        for t in threads:
            t.start()
        try:
            while any(t.is_alive() for t in threads):
                time.sleep(0.1)
        except KeyboardInterrupt:
            print("Interrupted: terminating running jobs ...")
            with self.lock:
                for proc in self.procs.values():
                    proc.terminate()
            raise
        print(f"Done: {len(self.completed)} succeeded, {len(self.failed)} failed.")


def pending_commands(log_dir: Path) -> List[str]:
    """The commands an interrupted queue left: those running when it
    stopped, then those not started."""
    journal = json.loads((log_dir / "completed.json").read_text())
    return list(journal.get("running", [])) + json.loads((log_dir / "queue.json").read_text())


def build_commands(args) -> List[str]:
    if args.command_file:
        return [line.strip() for line in Path(args.command_file).read_text().splitlines()
                if line.strip() and not line.startswith("#")]
    commands = []
    for config, task, size in itertools.product(args.cache_configs, args.tasks,
                                                args.cache_sizes):
        cmd = (f"{sys.executable} -m cold_compress_tpu_torch.eval --cache_config {config} "
               f"--tasks {task} --max_cache_length {size} --num_samples {args.num_samples}")
        if args.checkpoint_path:
            cmd += f" --checkpoint_path {args.checkpoint_path}"
        if args.extra_args:
            cmd += f" {args.extra_args}"
        commands.append(cmd)
    return commands


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Fan eval jobs out across card slots.")
    parser.add_argument("--command_file", type=str, default=None,
                        help="File with one shell command per line (overrides the grid).")
    parser.add_argument("--cache_configs", nargs="+", default=["full"])
    parser.add_argument("--tasks", nargs="+", default=["truthfulqa"])
    parser.add_argument("--cache_sizes", nargs="+", type=float, default=[1.0])
    parser.add_argument("--num_samples", type=int, default=500)
    parser.add_argument("--checkpoint_path", type=str, default=None)
    parser.add_argument("--extra_args", type=str, default=None)
    parser.add_argument("--num_slots", type=int, default=1, help="Concurrent card slots.")
    parser.add_argument("--device_env", type=str, default="CUDA_VISIBLE_DEVICES",
                        help="Env var used to pin a job to its slot.")
    parser.add_argument("--log_dir", type=Path, default=Path("results/parallel_logs"))
    parser.add_argument("--resume", action="store_true",
                        help="Run what the journal in --log_dir left, instead of the grid.")
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    commands = pending_commands(args.log_dir) if args.resume else build_commands(args)
    print(f"{len(commands)} jobs across {args.num_slots} slots")
    queue = JobQueue(commands, args.num_slots, args.log_dir, args.device_env)
    queue.run()
    return 1 if queue.failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
