"""Host-side data sources of the port: the AdaAttN datasets
(``datasets.py``), the batch loader and the prefetch onto the card
(``pipeline.py``), and the native video decoder (``video_native.py``)."""
