"""``python -m repro_torch.analysis`` — run the static plan verifier over
the spec registry and emit a JSON report; exit non-zero on any finding.

    python -m repro_torch.analysis --verify --p 2,3,5,8,16
    python -m repro_torch.analysis --verify --json report.json

The reference's ``--verify`` pass; it needs no device.
"""
import argparse
import sys

from .report import Report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--verify", action="store_true",
                    help="static plan verifier over the spec registry "
                         "(the only pass; the default)")
    ap.add_argument("--p", default="2,3,5,8,16",
                    help="comma-separated axis sizes")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the JSON report to PATH ('-' = stdout)")
    args = ap.parse_args(argv)

    from . import verify
    report = Report()
    ps = tuple(int(tok) for tok in args.p.split(",") if tok)
    report.extend("verify", verify.run(ps))

    out = report.as_json()
    if args.json == "-":
        print(out)
    elif args.json:
        with open(args.json, "w") as f:
            f.write(out + "\n")
    for f in report.findings:
        print("FINDING " + f.render())
    print(f"repro_torch.analysis: passes={','.join(report.passes_run)} "
          f"p={','.join(map(str, ps))} findings={len(report.findings)} "
          f"{'OK' if report.ok else 'FAIL'}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
