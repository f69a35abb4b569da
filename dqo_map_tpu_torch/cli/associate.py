"""Associate two TUM-format timestamp files (offline tool).

CLI twin of the reference's `scripts/associate.py` (TUM RGB-D toolkit role):
greedily pair timestamps from two `stamp d1 d2 ...` files whose difference
(after `--offset`) is below `--max_difference`, closest pairs first, each
stamp used once. Re-derived from the published file format — not a copy of
the TUM script.

    python -m dqo_map_tpu_torch.cli.associate rgb.txt depth.txt \
        [--offset 0] [--max_difference 0.02] [--first_only]
"""

from __future__ import annotations

import argparse


def read_stamped_file(path: str) -> dict:
    """{stamp: [fields...]} from a TUM `stamp d1 d2 ...` file ('#' comments
    and blank lines skipped)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.replace(",", " ").split()
            out[float(parts[0])] = parts[1:]
    return out


def associate(a: dict, b: dict, offset: float = 0.0,
              max_difference: float = 0.02) -> list:
    """Sorted list of (stamp_a, stamp_b) matches; greedy closest-first,
    one use per stamp."""
    cands = sorted(
        (abs(sa - (sb + offset)), sa, sb)
        for sa in a for sb in b
        if abs(sa - (sb + offset)) < max_difference
    )
    used_a, used_b, pairs = set(), set(), []
    for _, sa, sb in cands:
        if sa in used_a or sb in used_b:
            continue
        used_a.add(sa)
        used_b.add(sb)
        pairs.append((sa, sb))
    return sorted(pairs)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("first_file")
    p.add_argument("second_file")
    p.add_argument("--first_only", action="store_true",
                   help="print only the first file's matched lines")
    p.add_argument("--offset", type=float, default=0.0,
                   help="time offset added to the second file's stamps")
    p.add_argument("--max_difference", type=float, default=0.02)
    args = p.parse_args(argv)

    a = read_stamped_file(args.first_file)
    b = read_stamped_file(args.second_file)
    for sa, sb in associate(a, b, args.offset, args.max_difference):
        if args.first_only:
            print(f"{sa:f} {' '.join(a[sa])}")
        else:
            print(f"{sa:f} {' '.join(a[sa])} {sb - args.offset:f} "
                  f"{' '.join(b[sb])}")


if __name__ == "__main__":
    main()
