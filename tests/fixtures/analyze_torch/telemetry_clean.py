"""Clean twin for the telemetry pass: every constant stats key written
here is declared in repro_torch.serve.telemetry.DECLARED_STATS."""


class FakeEngine:
    def __init__(self, stats):
        self.stats = stats

    def step(self):
        self.stats["admitted"] += 1
        self.stats["generated_tokens"] += 4
        self.stats["memory"] = {"pages": 0}
