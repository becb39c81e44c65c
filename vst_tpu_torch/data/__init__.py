"""Host-side data sources of the port: the ReCoNet, RTNSTV and AdaAttN
datasets and RTNSTV's offline preprocessing (``datasets.py``), the flow readers (``flowio.py``, ``native.py``) and
host flow math (``flow_np.py``), the batch loader and the prefetch onto
the card (``pipeline.py``), and the native video decoder
(``video_native.py``)."""
