import sys

from dmlc_core_tpu_torch.analysis.driver import main

if __name__ == "__main__":
    sys.exit(main())
