"""Run records and solver checkpoints: the reference's log format and JSONL sink (``logger.py``), and ``.npz`` save and resume of every solver family (``checkpoint.py``)."""
