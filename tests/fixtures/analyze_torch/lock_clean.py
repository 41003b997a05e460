"""Clean twin of lock_bad.py: every shared access guarded, foreign
state reached through an owner method, hierarchy respected — zero
findings under the same fixture spec."""
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
        with self._lock:
            self.count += 1

    def forward(self, item: torch.Tensor):
        self.peer.push(item)            # owner method takes Peer._lock
