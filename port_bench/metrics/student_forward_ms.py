"""Milliseconds of the student model's forward a policy call (its span's
two device stamps), the mean over the window's calls."""


def read(run: dict):
    ms = run["spans"].get("student_forward")
    return sum(ms) / len(ms) if ms else None
