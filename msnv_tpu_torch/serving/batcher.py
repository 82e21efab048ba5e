"""Leader-follower dynamic batching for /synthesize (no worker thread)."""

from __future__ import annotations

import threading
import time


class _Batcher:
    """Leader-follower dynamic batching: concurrent requests of the same
    (frames, temperature, speaker-kind) group coalesce into ONE device
    call of up to `max_batch` lanes.

    The first request into a group becomes the leader: it lingers up to
    `linger_s` (or until the group fills), then executes the whole group
    and distributes results; followers just wait on their slot. No
    dedicated worker thread — idle servers cost nothing.
    """

    def __init__(self, run_group, max_batch: int, linger_s: float):
        self._run_group = run_group     # (gkey, [item]) -> [result]
        self.max_batch = int(max_batch)
        self.linger_s = float(linger_s)
        self._groups = {}               # gkey -> {"items": [...], "closed"}
        self._cv = threading.Condition()
        self.batch_sizes = []           # observability (tests/monitoring)

    def submit(self, gkey, item):
        slot = {"ev": threading.Event()}
        with self._cv:
            group = self._groups.get(gkey)
            if group is None or group.get("closed") \
                    or len(group["items"]) >= self.max_batch:
                group = {"items": [], "closed": False}
                self._groups[gkey] = group
            group["items"].append((item, slot))
            leader = len(group["items"]) == 1
            if len(group["items"]) >= self.max_batch:
                if self._groups.get(gkey) is group:
                    del self._groups[gkey]
                self._cv.notify_all()

        if leader:
            # monotonic: a wall-clock step must not stretch/collapse the
            # batching window
            deadline = time.monotonic() + self.linger_s
            with self._cv:
                while (len(group["items"]) < self.max_batch
                       and time.monotonic() < deadline):
                    self._cv.wait(
                        timeout=max(deadline - time.monotonic(), 1e-4))
                group["closed"] = True
                if self._groups.get(gkey) is group:
                    del self._groups[gkey]
                items = list(group["items"])
            self.batch_sizes.append(len(items))
            try:
                results = self._run_group(gkey, [it for it, _ in items])
                for (_, s), r in zip(items, results):
                    s["result"] = r
            except BaseException as e:  # even KeyboardInterrupt/SystemExit
                for _, s in items:      # must release every follower
                    s["error"] = e
            finally:
                for _, s in items:
                    s["ev"].set()

        slot["ev"].wait()
        if "error" in slot:
            raise slot["error"]
        return slot["result"]
