"""What the two codec runners share: the cell's frames, its codec settings
and the comparison of a roundtrip's stream and reconstruction with the
plain Haar reference."""

from __future__ import annotations

import torch

from benchmark.lib import frames
from benchmark.lib.runner import Check, Runner, mismatches
from benchmark.reference import haar


class CodecRunner(Runner):
    def make_frames(self) -> list[torch.Tensor]:
        shapes = frames.expand(self.cell.traffic["frames"])
        self.mp = [h * w / 1e6 for _, h, w in shapes]
        return [frames.photo_like(s, frames.derive(self.cell.seed, "frame", i), self.device)
                for i, s in enumerate(shapes)]

    def codec_args(self) -> dict:
        from wicca_tpu_torch import QuantSpec

        cfg = self.cell.config
        return {"levels": cfg["levels"], "spec": QuantSpec(base_step=cfg["base_step"]), "wavelet": cfg["wavelet"]}

    def reference(self, frame: torch.Tensor, dtype=torch.float64) -> haar.Roundtrip:
        cfg = self.cell.config
        return haar.roundtrip(frame.to(self.device), cfg["levels"], cfg["base_step"], dtype)

    def judge(self, answers, frame_of, dtype=torch.float64) -> tuple[list[Check], int]:
        """``answers``: ``(frame index, stream ll, [(lh, hl, hh)], reconstruction)``
        tuples; ``frame_of(i)`` the frame as made. Counts the stream's
        elements and the reconstruction's bytes that differ from the
        reference; returns the checks and how many answers were wrong."""
        codes = pixels = wrong = 0
        for idx in sorted({a[0] for a in answers}):
            ref = self.reference(frame_of(idx), dtype)
            for _, ll, details, recon in (a for a in answers if a[0] == idx):
                c = mismatches(ll, ref.ll)
                if len(details) != len(ref.details):
                    c += sum(b.numel() for bands in ref.details for b in bands)
                else:
                    c += sum(mismatches(g, w) for gb, wb in zip(details, ref.details) for g, w in zip(gb, wb))
                p = mismatches(torch.as_tensor(recon), ref.recon)
                codes, pixels, wrong = codes + c, pixels + p, wrong + bool(c or p)
            del ref
        return [Check("code_mismatch", codes, self.limit("code_mismatch")),
                Check("pixel_mismatch", pixels, self.limit("pixel_mismatch"))], wrong

    def control(self) -> list[Check]:
        """The reference in bfloat16 put in the program's place, on every frame."""
        made = self.make_frames()
        answers = []
        for idx, f in enumerate(made):
            low = self.reference(f, torch.bfloat16)
            answers.append((idx, low.ll, low.details, low.recon))
        return self.judge(answers, lambda i: made[i])[0]
