"""The yardstick: peak rates, kernel operation and byte counts, model FLOPs."""

import json
import os

PEAKS = json.load(open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")))
