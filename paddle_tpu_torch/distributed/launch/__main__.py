import sys

from .main import launch_main

sys.exit(launch_main())
