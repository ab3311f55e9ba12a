"""The data of a run, made on the device from ``--seed``.

The published files (DEEP, SIFT) need a download, which a run may not
make, so a configuration names a generator and its parameters instead
(listed under ``assumed`` in its file).  ``clustered`` is the repo's
``bench.py`` generator: ``centers`` normal centres, each row a random
centre plus ``sigma`` times a normal draw.  With ``integer`` the rows are
scaled, rounded and clipped to ``[0, max]``, as SIFT's non-negative
integers below 256 are.  Rows are not normalised: for an angular
configuration the program and the reference each normalise them.

Rows, queries, centres and the rows a write mix inserts come from four
streams of one seed, each with a generator of its own that later draws
continue, so a query or insert pool of any size leaves the rows
unchanged, a pool can grow without a repeat, and every seed gives the
same shapes."""

from __future__ import annotations

import numpy as np
import torch

BLOCK_ROWS = 1 << 20


def stream_seed(seed: int, stream: int) -> int:
    state = np.random.SeedSequence([seed % (1 << 64), stream])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Corpus:
    ROWS, QUERIES, CENTERS, INSERTS = 1, 2, 3, 7

    def __init__(self, generator: dict, dim: int, seed: int,
                 device: torch.device):
        if generator["kind"] != "clustered":
            raise ValueError(f"unknown generator {generator['kind']!r}")
        self.params = generator
        self.dim = dim
        self.seed = seed
        self.device = torch.device(device)
        self.streams: dict[int, torch.Generator] = {}
        self.centers = torch.randn(generator["centers"], dim,
                                   generator=self._gen(self.CENTERS),
                                   device=self.device)

    def _gen(self, stream: int) -> torch.Generator:
        g = self.streams.get(stream)
        if g is None:
            g = torch.Generator(device=self.device)
            g.manual_seed(stream_seed(self.seed, stream))
            self.streams[stream] = g
        return g

    def _draw(self, n: int, stream: int) -> np.ndarray:
        g = self._gen(stream)
        out = np.empty((n, self.dim), np.float32)
        sigma = float(self.params["sigma"])
        integer = self.params.get("integer")
        for s in range(0, n, BLOCK_ROWS):
            e = min(n, s + BLOCK_ROWS)
            pick = torch.randint(0, len(self.centers), (e - s,), generator=g,
                                 device=self.device)
            x = self.centers[pick] + sigma * torch.randn(
                e - s, self.dim, generator=g, device=self.device)
            if integer:
                x = torch.clamp(torch.round(integer["scale"] * x),
                                0, integer["max"])
            out[s:e] = x.cpu().numpy()
        return out

    def rows(self, n: int) -> np.ndarray:
        """``[n, dim]`` float32 rows on the host."""
        return self._draw(n, self.ROWS)

    def queries(self, n: int) -> np.ndarray:
        """The next ``n`` queries of the seed's query stream, ``[n, dim]``
        float32 on the host, drawn near the same centres as the rows."""
        return self._draw(n, self.QUERIES)

    def inserts(self, n: int) -> np.ndarray:
        """The next ``n`` rows of the seed's insert stream, ``[n, dim]``
        float32 on the host, drawn near the same centres as the rows: the
        rows a write mix adds (:class:`hxbench.loops.EngineLoop`)."""
        return self._draw(n, self.INSERTS)
