"""The batch job: ingest -> group -> project -> cascade -> blobs.

- ``groups``   — user-id routing rules (reference heatmap.py:64-70).
- ``timespan`` — timespan labels (reference heatmap.py:38-52).
- ``cascade``  — the zoom cascade and blob egress.
- ``feeder``   — the double-buffered host->device feeder of chunked jobs.
- ``batch``    — orchestration equivalent to the reference batchMain.
"""
