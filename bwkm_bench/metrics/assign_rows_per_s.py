"""Rows assigned a second: every row of every pass in the window, over the window."""

def read(rec):
    if rec["kind"] != "predict" or not rec["units"]:
        return None
    return rec["units"] * rec["rows_per_unit"] / rec["window_s"]
