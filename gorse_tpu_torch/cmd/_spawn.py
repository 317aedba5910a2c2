"""``python -m gorse_tpu_torch.cmd._spawn {master|server|worker} [args...]``

Starts one node role without installed console scripts (the cluster tests
and ``chip_smoke.py`` start the processes this way): dispatches to the
entry points in nodes_main.
"""

import sys

from . import nodes_main


def main() -> None:
    role = sys.argv[1]
    sys.argv = [f"gorse-tpu-torch-{role}"] + sys.argv[2:]
    {
        "master": nodes_main.master_main,
        "server": nodes_main.server_main,
        "worker": nodes_main.worker_main,
    }[role]()


if __name__ == "__main__":
    main()
