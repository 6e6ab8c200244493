"""The pipeline plane's transfer lane.  So far only its tree codec
(``transfer.py``), which the serving plane's adapter frames use."""
