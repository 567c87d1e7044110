import time

T_START = time.perf_counter()

import sys  # noqa: E402

from portbench.run import main  # noqa: E402

sys.exit(main(t_start=T_START))
