"""Clean twin of recompile_bad.py: the smallest bucket at or above the
length, the length itself past every bucket — within budget."""


class Engine:
    buckets = ()

    def _bucket_len(self, S: int) -> int:
        for b in self.buckets:
            if b >= S:
                return b
        return S
