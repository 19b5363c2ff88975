"""MOTChallenge summary -> LaTeX table rows (port of
``kinet_tpu/tools/parse_mot_results_to_tex.py``; reference:
src/parse_mot_results_to_tex.py).

Reads a json dump of the metric summary that ``engine/track.py::
main_track`` returns and prints a LaTeX table with the standard column
order: MOTA IDF1 HOTA MOTP Rcll Prcn FP FN IDSW (HOTA as in the
reference's MOT20 table, parse_mot_results_to_tex.py:72-79; left out when
no row has it).

    python -m kinet_tpu_torch.tools.parse_mot_results_to_tex summary.json
"""
from __future__ import annotations

import argparse
import json


def to_tex(summary: dict, caption: str = "Results") -> str:
    with_hota = any("hota" in m for m in summary.values())
    hota_col = "r" if with_hota else ""
    hota_hdr = " & HOTA" if with_hota else ""
    header = (
        "\\begin{table}\n\\centering\n"
        f"\\begin{{tabular}}{{l|rr{hota_col}rrr|rrr}}\n"
        f"Seq & MOTA & IDF1{hota_hdr} & MOTP & Rcll & Prcn & FP & FN "
        "& IDSW \\\\\n\\hline\n"
    )
    rows = []
    for name, m in summary.items():
        hota = (
            (f"{100 * m['hota']:.2f} & " if "hota" in m else "-- & ")
            if with_hota
            else ""
        )
        rows.append(
            f"{name} & {100 * m['mota']:.2f} & {100 * m['idf1']:.2f} & "
            f"{hota}"
            f"{100 * (1 - m['motp']):.2f} & {100 * m['recall']:.2f} & "
            f"{100 * m['precision']:.2f} & {m['num_false_positives']} & "
            f"{m['num_misses']} & {m['num_switches']} \\\\"
        )
    footer = (
        "\n\\end{tabular}\n"
        f"\\caption{{{caption}}}\n\\end{{table}}\n"
    )
    return header + "\n".join(rows) + footer


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("summary_json", help="json dump of the metric summary")
    p.add_argument("--caption", default="Results")
    args = p.parse_args(argv)
    with open(args.summary_json) as f:
        summary = json.load(f)
    print(to_tex(summary, args.caption))


if __name__ == "__main__":
    main()
