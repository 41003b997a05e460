"""Seeded concurrency violations, checked against the fixture lock
spec in tests/test_torch_analyze.py: LOCK-UNHELD (off-lock counter) and
LOCK-ORDER (acquisition against the declared hierarchy)."""
import threading

import torch


class Peer:
    def __init__(self):
        self._lock = threading.RLock()
        self.inbox = []

    def push(self, item: torch.Tensor):
        with self._lock:
            self.inbox.append(item)


class Worker:
    def __init__(self, peer):
        self._lock = threading.RLock()
        self.peer = peer
        self.count = 0

    def increment(self):
        self.count += 1                 # LOCK-UNHELD: off-lock write

    def forward(self, item: torch.Tensor):
        # LOCK-ORDER: declared hierarchy is Peer then Worker, but this
        # acquires Peer._lock while already holding Worker._lock
        with self._lock:
            with self.peer._lock:
                self.peer.inbox.append(item)
