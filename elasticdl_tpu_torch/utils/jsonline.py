"""Last-JSON-line extraction shared by every bench/preflight harness.

Benchmark subprocesses print exactly one JSON line as their final
output, but loggers and warnings share the stream; the convention is
"the LAST line that parses as a JSON object wins".
"""

import json


def last_json_line(text):
    """The last parseable {...} line in ``text``, or None."""
    for line in reversed((text or "").strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            try:
                return json.loads(line)
            except json.JSONDecodeError:
                continue
    return None
