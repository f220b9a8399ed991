import sys

from dorado_tpu_torch.cli.main import crash_hook, main

if __name__ == "__main__":
    sys.excepthook = crash_hook
    sys.exit(main())
