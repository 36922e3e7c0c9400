"""Single front door for the port's launchers: ``python -m repro_torch <cmd>``.

Each subcommand forwards argv to the matching ``repro_torch.launch.*``
module, so ``python -m repro_torch calibrate --arch ...`` and
``python -m repro_torch.launch.calibrate --arch ...`` are the same program.
``dryrun`` and ``breakdown`` cost every cell on the ``meta`` device and need
no card.
"""
import importlib
import sys

COMMANDS = {
    "calibrate": ("repro_torch.launch.calibrate", "search a QuantPolicy from "
                  "calibration activations"),
    "serve": ("repro_torch.launch.serve", "offline packing + batched decode"),
    "train": ("repro_torch.launch.train", "train-loop entry"),
    "profile": ("repro_torch.launch.profile", "device activity of a serve's "
                "decode step"),
    "dryrun": ("repro_torch.launch.dryrun", "every (arch x shape) cell costed "
               "on meta: residency, peak, roofline terms"),
    "breakdown": ("repro_torch.launch.breakdown", "where a dry-run cell's "
                  "bytes and FLOPs live"),
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m repro_torch <command> [args]\n\ncommands:")
        for name, (_, desc) in COMMANDS.items():
            print(f"  {name:10} {desc}")
        return 0 if argv else 2
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r} (expected one of "
              f"{', '.join(COMMANDS)})", file=sys.stderr)
        return 2
    mod = importlib.import_module(COMMANDS[cmd][0])
    return mod.main(argv[1:]) or 0


if __name__ == "__main__":
    sys.exit(main())
