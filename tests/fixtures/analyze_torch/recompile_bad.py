"""Seeded RECOMPILE-BUDGET violation: an engine whose bucketing
regressed to exact shapes, so every prompt length is a shape of its own
(the recompile pass's sweep over the launch flags with this engine's
``_bucket_len``)."""


class Engine:
    buckets = ()

    def _bucket_len(self, S: int) -> int:
        return S                        # bucketing disabled
