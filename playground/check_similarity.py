"""Self-audit: report repo files whose text is suspiciously similar to any
same-named or similar-sized file in the (read-only) reference tree.

This codebase is a ground-up JAX redesign, not a port; this script
keeps us honest about it.  Usage: python playground/check_similarity.py
[threshold=0.45]
"""

from __future__ import annotations

import difflib
import pathlib
import sys

REF = pathlib.Path("/root/reference")
REPO = pathlib.Path(__file__).parent.parent


def main(threshold: float = 0.45) -> int:
    if not REF.exists():
        print("reference tree not mounted; nothing to check")
        return 0
    ref_files = [p for p in REF.rglob("*.py") if p.is_file()]
    by_name = {p.name: p for p in ref_files}
    flagged = []
    for mine in sorted(REPO.rglob("*.py")):
        parts = mine.parts
        if ".git" in parts or "__pycache__" in parts:
            continue
        text = mine.read_text(errors="replace")
        cands = set()
        if mine.name in by_name:
            cands.add(by_name[mine.name])
        size = len(text)
        cands.update(
            p for p in ref_files if 0.8 * size <= p.stat().st_size <= 1.2 * size
        )
        best, best_p = 0.0, None
        for p in cands:
            other = p.read_text(errors="replace")
            sm = difflib.SequenceMatcher(None, text, other)
            if sm.quick_ratio() <= max(best, 0.4):
                continue
            r = sm.ratio()
            if r > best:
                best, best_p = r, p
        if best >= threshold and best_p is not None:
            flagged.append((best, mine.relative_to(REPO), best_p.relative_to(REF)))
    flagged.sort(reverse=True)
    for r, mine, ref in flagged:
        marker = "!!" if r > 0.60 else "  "
        print(f"{marker} {r:.2f}  {mine}  <->  {ref}")
    over = sum(1 for r, *_ in flagged if r > 0.60)
    print(f"{len(flagged)} file(s) >= {threshold:.2f}; {over} over 0.60")
    return 1 if over else 0


if __name__ == "__main__":
    thr = float(sys.argv[1]) if len(sys.argv) > 1 else 0.45
    sys.exit(main(thr))
