"""What compile() records: the search trajectory (obs/trajectory.py)."""
from .trajectory import SearchTrajectory  # noqa: F401
