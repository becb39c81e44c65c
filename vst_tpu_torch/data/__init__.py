"""Host-side data sources of the port: the ReCoNet and AdaAttN datasets
(``datasets.py``), the flow readers (``flowio.py``, ``native.py``) and
host flow math (``flow_np.py``), the batch loader and the prefetch onto
the card (``pipeline.py``), and the native video decoder
(``video_native.py``)."""
