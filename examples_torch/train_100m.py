"""End-to-end training driver on the port (``repro_torch``): a ~100M-param
granite-family model trained for a few hundred steps with the production
stack (AdamW, remat, data pipeline, async checkpointing, restart recovery).

The reference trains on the CPU; the port trains on the card, through the
flash-attention kernel forward and backward.  The flags and the rule that
overrides them are the reference's; the checkpoints go to a directory of the
port's own under the temporary directory, never the reference's, and the
run resumes from the newest checkpoint it finds there.

    PYTHONPATH=src python examples_torch/train_100m.py            # full
    PYTHONPATH=src python examples_torch/train_100m.py --steps 30 # quick look
"""
import os
import sys
import tempfile

from repro_torch.launch import train

FLAGS = ["--arch", "granite-3-2b", "--reduce",
         "--steps", "200", "--batch", "8", "--seq", "256",
         "--lr", "3e-3", "--ckpt-every", "50"]


def arguments(extra) -> list:
    """FLAGS and the checkpoint directory, with ``extra`` (flag, value
    pairs) laid over them: a flag already there takes the new value, another
    one is appended."""
    args = FLAGS + ["--ckpt-dir", os.path.join(tempfile.gettempdir(),
                                               "repro_torch_100m_ckpt")]
    for i in range(0, len(extra), 2):
        if extra[i] in args:
            j = args.index(extra[i])
            args[j + 1] = extra[i + 1]
        else:
            args += extra[i:i + 2]
    return args


def main(argv=None) -> None:
    train.main(arguments(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
