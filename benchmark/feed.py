"""The port's loader read as one stream across its epochs, handed to the
port's own loops as loader-like views: a fixed number of batches (set-up)
or batches until the window's deadline. Each batch handed out is a
`loader` span (the wait for it) and a `step` span (what the consumer does
with it until it asks for the next)."""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple


class Feed:
    def __init__(self, loader, ctx):
        self.loader = loader
        self.ctx = ctx
        self.epoch = 0
        self.batch = 0
        self.it: Optional[Iterator] = None
        self.served: List[Tuple[int, int]] = []  # (epoch, batch) handed out

    def next(self):
        while True:
            if self.it is None:
                self.loader.set_epoch(self.epoch)
                self.it = iter(self.loader)
                self.batch = 0
            try:
                x = next(self.it)
            except StopIteration:
                self.it = None
                self.epoch += 1
                continue
            self.served.append((self.epoch, self.batch))
            self.batch += 1
            return x

    def take(self, n: int) -> "Batches":
        return Batches(self, limit=n)

    def until_deadline(self) -> "Batches":
        return Batches(self, limit=None)

    def close(self) -> None:
        if self.it is not None:
            self.it.close()
            self.it = None
        self.loader.close()


class Batches:
    """A loader-like view of a `Feed`: `len` and `set_epoch` as the port's
    loops ask for them (the feed keeps its own epochs)."""

    def __init__(self, feed: Feed, limit: Optional[int]):
        self.feed, self.limit = feed, limit
        self.count = 0

    def __len__(self) -> int:
        return len(self.feed.loader)

    def set_epoch(self, epoch: int) -> None:
        pass

    def __iter__(self):
        ctx = self.feed.ctx
        while True:
            ctx.tick()
            if self.limit is None:
                if ctx.due:
                    return
            elif self.count >= self.limit:
                return
            with ctx.spans("loader"):
                x = self.feed.next()
            with ctx.spans("step"):
                yield x
            self.count += 1
