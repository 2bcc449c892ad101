"""Word or phoneme error-rate statistics (the port's own copy of
``mlvae_tpu/metrics/error_rate.py``): SpeechBrain's ``ErrorRateStats`` as
the CTC recipes use it, ``append(ids, predict, target, target_len,
ind2lab)`` and ``summarize("error_rate")``. Host-side Python."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from mlvae_tpu_torch.metrics.alignment import edit_alignment
from mlvae_tpu_torch.utils.tensor import undo_padding


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


class ErrorRateStats:
    def __init__(self):
        self.clear()

    def clear(self):
        self.ids: List[str] = []
        self.details: List[dict] = []

    def append(self, ids, predict, target, target_len=None, ind2lab=None,
               predict_len=None):
        targets = undo_padding(_host(target), _host(target_len)) \
            if target_len is not None else [_host(t) for t in target]
        if predict_len is not None:
            predict = undo_padding(_host(predict), _host(predict_len))
        for utt_id, hyp, ref in zip(ids, predict, targets):
            hyp = [int(x) for x in np.asarray(hyp).reshape(-1)]
            ref = [int(x) for x in np.asarray(ref).reshape(-1)]
            ops = edit_alignment(ref, hyp)
            counts = {"=": 0, "S": 0, "D": 0, "I": 0}
            for op, _, _ in ops:
                counts[op] += 1
            self.ids.append(utt_id)
            self.details.append({
                "utt_id": utt_id, "ref": ref, "hyp": hyp, "ops": ops,
                "num_ref": len(ref),
                "errors": counts["S"] + counts["D"] + counts["I"],
                "ins": counts["I"], "del": counts["D"], "sub": counts["S"],
                "ind2lab": ind2lab,
            })

    def summarize(self, field: Optional[str] = None):
        if not self.details:
            raise ValueError("no scores appended")
        total_ref = sum(d["num_ref"] for d in self.details)
        total_err = sum(d["errors"] for d in self.details)
        stats = {
            "error_rate": round(100.0 * total_err / max(total_ref, 1), 2),
            "insertions": sum(d["ins"] for d in self.details),
            "deletions": sum(d["del"] for d in self.details),
            "substitutions": sum(d["sub"] for d in self.details),
            "num_ref_tokens": total_ref,
        }
        return stats if field is None else stats[field]

    def write_stats(self, f):
        stats = self.summarize()
        f.write(
            f"%ER {stats['error_rate']} [ {stats['substitutions']} sub, "
            f"{stats['deletions']} del, {stats['insertions']} ins / "
            f"{stats['num_ref_tokens']} ref tokens ]\n")
        for d in self.details:
            ind2lab = d["ind2lab"]

            def fmt(seq):
                if ind2lab is None:
                    return " ".join(str(x) for x in seq)
                out = []
                for x in seq:
                    try:
                        out.append(ind2lab([x])[0])
                    except KeyError:
                        # an untrained CTC head can argmax the unused
                        # (n_phonemes+2)th class, which has no label
                        out.append(f"<unk:{x}>")
                return " ".join(out)
            f.write(f"{d['utt_id']}: ref= {fmt(d['ref'])}\n")
            f.write(f"{' ' * len(str(d['utt_id']))}  hyp= {fmt(d['hyp'])}\n")
