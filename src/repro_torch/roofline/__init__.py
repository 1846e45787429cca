"""The roofline count of the port: the card's peaks and the three terms
(analyze.py), and the count of the work an eager function does
(count.py), the counterpart of the JAX package's roofline/hlo.py."""
