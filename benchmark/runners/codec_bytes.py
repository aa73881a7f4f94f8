"""``.wct`` roundtrips of frames held on the host: ``encode`` on the card,
``container.serialize`` at its defaults to bytes in memory,
``container.deserialize`` at its defaults, ``decode(emit_u8=True)``, back
to numpy; one frame in flight, nothing written to disk. Spans:
``encode``, ``serialize``, ``deserialize``, ``decode``."""

from __future__ import annotations

from benchmark.lib.frames import derive
from benchmark.lib.runner import Reservoir, sync
from benchmark.runners._codec import CodecRunner


class Runner(CodecRunner):
    def build(self) -> None:
        """The kernel library and the container's entropy coders (g++)."""
        from wicca_tpu_torch.native import rice

        super().build()
        rice.library()

    def setup(self) -> None:
        from wicca_tpu_torch import decode, encode
        from wicca_tpu_torch.codec import container

        self.encode, self.decode, self.container = encode, decode, container
        with self.phase("inputs"):
            self.frames = [f.cpu().numpy() for f in self.make_frames()]
        self.args = self.codec_args()
        self.keep = Reservoir(int(self.cell.traffic["sample"]), derive(self.cell.seed, "sample"))
        with self.phase("warm"):  # every shape
            self._roundtrip(self.frames[0])
        self.last = None

    def _roundtrip(self, x):
        with self.span("encode"):
            stream = self.encode(x, device=self.device, **self.args)
        with self.span("serialize"):
            data = self.container.serialize(stream)
        with self.span("deserialize"):
            back = self.container.deserialize(data, device=self.device)
        with self.span("decode"):
            recon = self.decode(back, emit_u8=True).cpu().numpy()
        self.counters["wct_bytes"] += len(data)
        return back, recon

    def step(self, i: int) -> float:
        idx = i % len(self.frames)
        back, recon = self._roundtrip(self.frames[idx])
        answer = (idx, back.ll, back.details, recon)
        slot = self.keep.slot()
        if slot is not None:
            self.keep.items[slot] = answer
        self.last = answer
        return self.mp[idx]

    def check(self):
        import torch

        answers = [a for a in self.keep.items if a is not None and a is not self.last] + [self.last]
        return self.judge(answers, lambda i: torch.from_numpy(self.frames[i]))
