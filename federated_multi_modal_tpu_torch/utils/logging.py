"""Stdout tee logger.

The reference's metrics pipeline is "print to stdout, tee into
``OUTPUT_DIR/log.txt``, regex-parse later" (Dassl ``setup_logger`` called at
``train.py:168``; parsing contract in ``parse_test_res.py:126-152``).  The
same contract is preserved so ``tools/parse_test_res.py`` works unchanged.
"""

import os.path as osp
import sys
import time

from federated_multi_modal_tpu_torch.utils.io import mkdir_if_missing


class _TeeLogger:
    def __init__(self, fpath: str):
        self.console = sys.stdout
        mkdir_if_missing(osp.dirname(fpath))
        self.file = open(fpath, "a")

    def write(self, msg):
        self.console.write(msg)
        self.file.write(msg)
        if "\n" in msg:  # line-flush so logs survive preemption/termination
            self.file.flush()
        return len(msg)

    def flush(self):
        self.console.flush()
        self.file.flush()

    def close(self):
        self.file.close()


def setup_logger(output_dir: str = None) -> None:
    if output_dir is None:
        return
    fpath = osp.join(output_dir, "log.txt")
    if osp.exists(fpath):
        # keep old logs distinguishable, same convention as Dassl
        fpath += time.strftime("-%Y-%m-%d-%H-%M-%S")
    sys.stdout = _TeeLogger(fpath)
