"""Seeded TELEMETRY-DECLARED violations: stats keys written but never
declared in repro_torch.serve.telemetry.DECLARED_STATS."""


class FakeEngine:
    def __init__(self, stats):
        self.stats = stats

    def step(self):
        # undeclared key via augmented assignment
        self.stats["bogus_counter"] += 1
        # undeclared key via plain assignment
        self.stats["mystery_gauge"] = 42
        # declared key — must NOT be flagged
        self.stats["admitted"] += 1
        # dynamic key — out of scope for the lint
        k = "computed"
        self.stats[k] = 1
