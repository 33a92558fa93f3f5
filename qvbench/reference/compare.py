"""The comparison that decides `correct`.

For each checked request the reference runs once over the prompt with the
program's served tokens fed back, keeping the rows the program kept after
judging each (group, layer)'s set by its own key norms. Three numbers come
out, each compared with its limit from qvbench/limits/<cell>.json where
that file gives one (a number a cell's control does not separate from the
program's readings has none there, and is only printed):

  logit_gap        the widest gap by which a served token's logit lies
                   below the reference's best at its position
  kept_off_share   the share of the rows the program kept, over every
                   pruned (group, layer) of the checked requests, that the
                   reference's own choice (the k smallest key norms by its
                   own keys) drops; a set of the wrong size counts whole
  length_mismatch  layers whose cache length after the request differs from
                   the count the mix gives (exact: limit 0)

Standard error also gets, uncompared, the widest relative distance by
which a kept row's key norm lies above the reference's k-th smallest or a
dropped row's below its (k+1)-th (`kept_norm_excess`): an extreme over
hundreds of sets, it swings from seed to seed and does not separate the
program from its control by three times.

The control (the reference at the precision below the configuration's, put
in the program's place) is judged the same way: its own kept sets, and at
each position the token it puts first.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Sequence

import torch

from qvbench.reference.model import Weights, expected_lengths, run_request

NUMBERS = ("logit_gap", "kept_off_share", "length_mismatch")


def _log(ref) -> None:
    print("[qvbench] reference request: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in ref.clock.items()),
          file=sys.stderr, flush=True)


def gaps(logits: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
    tok = torch.as_tensor(list(tokens), device=logits.device)
    best = logits.max(-1).values
    return best - logits.gather(1, tok[:, None])[:, 0]


def readings(ref, tokens, lengths, expected) -> Dict[str, float]:
    judged = [v for group in ref.verdicts for v in group]
    return {
        "logit_gap": float(gaps(ref.logits, tokens).max()),
        "kept_off": sum(v[0] for v in judged),
        "kept_rows": sum(v[2] for v in judged),
        "kept_norm_excess": max(v[1] for v in judged),
        "length_mismatch": float(sum(a != b for a, b in
                                     zip(lengths, expected))
                                 + abs(len(lengths) - len(expected))),
    }


def worst(all_readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The numbers over every checked request: widest gap, worst norm
    excess, mismatched layers summed, and the off share of all kept rows."""
    rows = sum(r["kept_rows"] for r in all_readings)
    out = {
        "logit_gap": max(r["logit_gap"] for r in all_readings),
        "kept_off_share": (sum(r["kept_off"] for r in all_readings)
                           / rows if rows else 0.0),
        "kept_norm_excess": max(r["kept_norm_excess"] for r in all_readings),
        "length_mismatch": sum(r["length_mismatch"] for r in all_readings),
    }
    print(f"[qvbench] kept_norm_excess {out['kept_norm_excess']!r} "
          "(not compared)", file=sys.stderr, flush=True)
    return out


def check_program(tree, spec, mix, pool, records, device):
    """Readings of the program's checked requests (records with .video,
    .question, .tokens, .retained, .layer_lengths), worst over them."""
    wts = Weights(tree, spec, "int8" if spec.int8_weights else "bf16")
    out = []
    for r in records:
        ref = run_request(wts, spec, mix, pool, r.video, r.question,
                          r.tokens, device, retained=r.retained)
        out.append(readings(ref, r.tokens, r.layer_lengths,
                            expected_lengths(spec, mix, r.question,
                                             len(r.tokens))))
        _log(ref)
        del ref
    return worst(out)


def check_control(tree, spec, mix, pool, records, device, precision):
    """Readings of the reference at `precision` in the program's place,
    over the same prompts and served tokens: its own kept sets, and its
    first token at each position, judged by the reference."""
    wts = Weights(tree, spec, "int8" if spec.int8_weights else "bf16")
    low = Weights(tree, spec, precision)
    out = []
    for r in records:
        ctl = run_request(low, spec, mix, pool, r.video, r.question,
                          r.tokens, device)
        firsts, kept = ctl.logits.argmax(-1).tolist(), ctl.kept
        del ctl
        ref = run_request(wts, spec, mix, pool, r.video, r.question,
                          r.tokens, device, retained=kept)
        out.append(readings(ref, firsts, ref.lengths,
                            expected_lengths(spec, mix, r.question,
                                             len(r.tokens))))
        del ref
    return worst(out)
