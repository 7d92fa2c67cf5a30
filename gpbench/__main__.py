import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# every build and kernel cache inside the checkout, at fixed paths
_CACHE = Path(__file__).resolve().parents[1] / "build" / "gpbench"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(_CACHE / "cuda")
os.environ["USE_FLAX"] = "0"

from gpbench.run import main  # noqa: E402

sys.exit(main(t_start=T_START))
