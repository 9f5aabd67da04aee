"""pctpu's benchmark driver on the card: ``pctpu_torch.experiments.bench``.

    python3 bench_torch.py [--verify] [--details] [--details-path=PATH]
        [--small] [--device=cuda|cpu]

Prints one JSON line (see the module's docstring); exits 2 without a card
unless ``--device=cpu`` is given."""

import sys

from pctpu_torch.experiments.bench import main

if __name__ == "__main__":
    sys.exit(main())
