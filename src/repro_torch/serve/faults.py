"""Sentinel token values shared by the serve programs and the engine.

Copied from the reference's ``serve/faults.py``; the seeded fault plan
itself arrives with the robustness slice of the port.
"""

# Token value the decode/prefill programs report for a lane whose logits
# hold a non-finite value (vocab ids are >= 0, so the sentinel rides the
# existing (max_slots,) int32 token fetch: no extra host sync).
NONFINITE_TOKEN = -1

# Speculative-decode verify rows: entries past a lane's accepted prefix.
UNCOMMITTED = -2
