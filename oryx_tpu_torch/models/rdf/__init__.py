"""Random decision forest: the histogram trainer on the card, PMML codec,
and the speed and serving models (host code; reference: app/oryx-app-
{common,mllib,app,serving} rdf packages of the original Oryx)."""
